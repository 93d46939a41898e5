#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every CUDA source of the port with nvcc (in parallel);
3. kernel vs plain: ``fake_quant`` (affine at 4/8/16 bits, pow2) in
   float32 and bfloat16 on the 15 VGG-16/CIFAR-10 weight shapes, two
   ragged ones, a prefill's activations with one scale for the tensor
   and a view off a 16-byte boundary, launched per tensor and as one
   group, held to its plain torch version on the same tensors (0
   differing elements, and within 1e-6), and timed (grouped, per weight,
   with the L2 flushed) beside the plain version,
   ``torch.fake_quantize_per_channel_affine`` and the memory bound; then
   the shapes phase 7 gives it, one by one and as one group, at 0
   differing elements: SmolLM-135M's projection weights and tied head
   (576 x 49152) in float32 with a scale a column, and its decode and
   prefill activations with one scale, in both types;
4. the slice: the quickstart loop at full size on the card (27,000-point
   paper grid, VGG-16/CIFAR-10, oracle and surrogate DSE, Pareto, report,
   best LightPE-1 design, every preset's fake quantization of VGG-16's
   weights), with kernel launches counted over that run (exactly 5: one
   grouped launch a quantizing preset, two for LightPE-2) and the results
   held to ``tests/data/torch_quickstart_ref.json`` (the JAX package's);
   then a 2^20-point subsample of WIDE_SPACE in 65,536-point chunks;
5. kernel vs plain, slice 2: ``quant_matmul`` (int4, pow2, int8; float32
   and bfloat16 x) at SmolLM-135M's projection shapes for decode (M = 4)
   and prefill (M = 4 * 130), at M = 1, 16, 17 and 64 (the edges of the
   GEMV and tensor-core variants), three ragged shapes and a layer view
   off a 16-byte boundary, held to its plain version within rtol 1e-5 /
   atol 1e-4, and two calls held to the same bits; ``flash_attention`` (GQA 9/3,
   head_dim 64) at the prefill shape and at decode (Sq 1 and 2) at offsets
   0, 1, 63, 135 and 255 (across the cluster's split boundaries), with
   float32 q and the float32 cache (the served path) and bfloat16 q on
   the same cache, round_p on and off, and three ragged shapes, within
   2e-5, two calls held to the same bits; each kernel timed beside its
   plain version, a library call and its bound (``flash_attention`` at
   the served types and with bfloat16 q);
6. the slice of serving: SmolLM-135M at full width (numpy-drawn weights),
   packed as LightPE-1 and as INT8 and served in bfloat16 and float32 by
   ``ServeEngine`` (4 prompts of 8-130 tokens in 4 slots, 12 new tokens
   each; then 6 requests in 4 slots), with the launches of the 4 x 12 run
   counted (exactly 2,520 ``quant_matmul`` and 360 ``flash_attention``) and
   every run held to ``tests/data/torch_serve_ref.json`` (the JAX
   package's); then prefill and decode times, tokens/s and peak memory;
7. the slice of QAT numerics: SmolLM-135M at full width on its dense
   weights under INT16, LightPE-1, LightPE-2 and INT8 numerics in
   bfloat16 and LightPE-1 in float32 (``fake_quant`` on every weight and
   every activation, bfloat16 activations included), served by
   ``ServeEngine`` (the 4 prompts in 4 slots, 12 new tokens each), with
   ``fake_quant`` launches counted per run (exactly 12 steps x (30 x 7
   projections + the head) x 2 passes, weight and activation; 3 for
   LightPE-2, whose weights take two) and every run held to the
   ``qat_modes`` of ``tests/data/torch_serve_ref.json``, with the steps
   compared and the tolerated near ties recorded; as a control, the
   bfloat16 LightPE-1 run held to the float32 LightPE-1 reference must
   fail that comparison;
8. the slice of joint co-exploration (no kernel of its own: the
   evaluator is eager torch): ``coexplore_front`` over the 13-model
   ``default_model_set`` x the 27,000-point paper grid (351,000 joint
   points, oracle) with mixed-model lanes, held to
   ``tests/data/torch_coexplore_ref.json`` (the JAX package's front as
   an index set up to near ties, objectives at 1e-5, front counts, layer
   buckets, per-(model, PE) bests and the LightPE claim for every
   model); the same walk per model, bitwise equal; under
   ``Budget(area_mm2=0.9)`` two-stage and single-stage, bitwise equal to
   each other and held to the reference's counts and front; 4,500
   points under ``Budget(area_mm2=2.0, power_mw=250.0)`` held to the
   reference; and 4,500 points under phase 4's fitted surrogate, mixed
   and per model, bitwise equal; each walk's wall time and points/s;
9. DSE at scale (``core/shard``, ``core/search``, ``serve/frontserver``,
   ``obs``; no kernel of its own but the serving run's): the 351,000-point
   joint walk sharded 4 ways with 2 chunks a shard in flight (a CUDA
   stream a shard) and a ``Tracer``, bitwise equal to phase 8's walk
   (front, bests, claim), with 4 shard lanes in its Chrome trace and its
   ``SweepReport`` phases within its wall time; the same sharded under
   ``Budget(area_mm2=0.9)``; killed after 40 chunks and resumed from its
   checkpoint, bitwise equal, and a wrong signature refused; 2^20 points
   of WIDE_SPACE sharded 4 ways with the front streamed to CSV, bitwise
   equal to the unsharded walk; ``search_front`` (evolve, halving) at
   40,000 evaluations over 3 models x ``MAPPED_SPACE``, shards 1 and 4
   bitwise equal, held to ``tests/data/torch_scale_ref.json`` generation
   by generation up to the first near tie, with ``hv_ratio`` and
   coverage against the ``REF_SPACE`` front (itself held to the
   reference's); the 12-query
   storm on one ``FrontServer`` walk held to the same file, queries 1
   and 3 bitwise equal to standalone walks, a repeat and a restored
   cache answering with 0 chunk evaluations; and phase 6's LightPE-1
   run with telemetry on, bitwise equal to the run with it off, with the
   launches and ``serve.*`` counts; each step's wall time and points/s;
10. training (``data``, ``optim``, ``models/cnn``, ``train``, the
   training checkpoints): the ``flash_attention`` backward kernel against
   its plain version at the training shape (16 x 256, 9/3 heads, float32
   q, k, v as the QAT model gives them, and bfloat16) and at the
   reference file's shape, two calls bitwise equal, timed beside the
   plain version, SDPA's backward, the CUDA-core kernel it replaced (a
   constant, printed only) and two bounds: the gradient's 5 products as
   kept bf16 part products on the tensor cores (``bound_ms``) and on the
   float32 CUDA cores; beside them the part products the kernel issues,
   which are its work and no bound; the full-width LM
   (FP32, LightPE-1) and ResNet-8 (four PE types) steps held to
   ``tests/data/torch_train_ref.json`` (the JAX package's) at
   ``TRAIN_LM_RTOL`` / ``TRAIN_CNN_RTOL``, with two controls that must
   fail (the attention's output detached, the parent's behaviour; the
   LightPE-1 run against the FP32 reference); 20 steps of full-width
   SmolLM-135M under LightPE-1 at 16 x 256 (AdamW), with exactly 842
   ``fake_quant``, 60 forward and 30 backward ``flash_attention`` launches
   a step (each layer recomputed in the backward) and a falling loss (step time, tokens/s, peak memory); 10 steps
   straight against 5, a checkpoint, a restore and 5 more, bitwise; and
   the Figs. 5-6 run (``--mode cnn``, 150 steps, one trial), after two
   runs of its LightPE-1 step from one seed held bitwise equal, its table
   loaded by the port's ``AccuracySurrogate`` and held to the paper's
   story;
11. the decoder family (``models/moe``, windows, soft-caps and head_dim
   256 in ``flash_attention``): 11.1 the kernel with a sliding window
   and head_dim 256 at Gemma-3-1B's shapes (4/1 heads, window 512) and
   with a soft-cap of 50 and a query scale of 1/16 at Gemma-2-9B's (16/8
   heads, window 4096), decode and prefill past the window (S = 900 and
   4608), float32 and bfloat16 q on a float32 cache, held to its plain
   version within 2e-5, two calls bitwise equal, timed beside the plain
   version, its bound and SDPA with the window as a boolean mask (with
   the soft-cap, ``flex_attention`` compiled, its score_mod the cap),
   the prefills on the wgmma kernel (``csrc/flash_attention_wgmma.cu``),
   the times of the split kernel it replaced printed beside as constants
   (``REPLACED_MS``);
   11.2 Gemma-3-1B at full width and
   depth, packed as LightPE-1 and INT8 and served by ``ServeEngine`` (4
   prompts of 64-900 tokens, a 1024-row cache, 12 new tokens) in
   bfloat16 and float32, held to ``tests/data/torch_gemma3_ref.json``
   with exactly 182 ``quant_matmul`` and 26 ``flash_attention`` launches
   a step, then timed warm (step latencies, tokens/s, peak memory); 11.3
   DeepSeek-MoE-16B at full width with its depth cut to 3 layers (1
   dense + 2 MoE) on dense float32 weights, served in bfloat16 under FP32,
   LightPE-1 and INT8 numerics, held to ``tests/data/torch_moe_ref.json``
   (routing included, up to router near ties, which are counted) with
   exactly 3 ``flash_attention`` and, under QAT numerics, 56
   ``fake_quant`` launches a step;
12. every attention path of the reference on the ported kernels (the
   perf variants, mixed precision, the encoder-decoder family), held to
   ``tests/data/torch_variants_ref.json`` (the JAX package's): 12.1
   Gemma-3-1B under ``attn_block_local`` (``forward`` on 2 x 1024 tokens,
   LightPE-1 codes, bfloat16) at the reference's cut depth of 8 layers
   against the JAX forward and at full depth against the port's baseline
   forward, one ``flash_attention`` and 7 ``quant_matmul`` launches a
   layer; 12.2 Gemma-3-1B served with ``kv_replicate_to=4`` on phase
   11.2's requests against ``tests/data/torch_gemma3_ref.json`` and phase
   11.2's tokens; 12.3 SmolLM-135M under ``attn_flash``, ``forward`` at 4
   x 2048 in float32 and bfloat16, and 3 AdamW steps at 4 x 128 (FP32,
   LightPE-1) through the attention backward; 12.4 its 3 LightPE-1 steps
   under ``compute_dtype(bfloat16)``; 12.5 Whisper-medium's greedy run
   (4 x 1500 frames, prompts of 8, 12 tokens, a 448-row cache) at the
   reference's cut depth of 4 + 4 layers on dense, LightPE-1 and INT8
   weights against the JAX runs, and at full depth (24 + 24) on
   LightPE-1 codes with 384 / 240 ``quant_matmul`` and 72 / 48
   ``flash_attention`` launches a prefill / decode step, timed; 12.6 the
   ``flash_attention`` kernel alone at those paths' shapes against its
   plain version, timed beside it, SDPA and its bound;
13. the SSM and hybrid families (``models/{ssm_common,rwkv,mamba,
   hybrid}``; ``quant_matmul`` under a bfloat16 cast is held in phase
   5): 13.1 the ``flash_attention`` kernel at head_dim 112 (Zamba2-7B's
   shared attention, 32/32 heads, the engine's float32 cache) at prefill
   (4 x 130) and decode, float32 and bfloat16 q, against its plain
   version within 2e-5, two calls bitwise equal, timed beside the plain
   version, SDPA and its bound; 13.2 RWKV6-1.6B and 13.3 Zamba2-7B at
   full width on dense float32 weights, served in bfloat16 under the
   FP32 preset, LightPE-1 and INT8: the first layer's ``fake_quant``
   calls against their plain version (0 differing elements), the runs at
   the reference's cut depth (4 / 13 layers) against
   ``tests/data/torch_ssm_ref.json`` with exactly 2 x 33 / 2 x 41
   ``fake_quant`` and 0 / 2 ``flash_attention`` launches a QAT step and
   a control that must fail, then at full depth (24 / 81 layers, drawn
   on the card) against the same runs on the kernels' plain versions,
   with exactly 386 / 508 and 0 / 13 launches a step, and the LightPE-1
   run timed warm; 13.4 both reduced configs packed as LightPE-1 and
   INT8 codes against the reference's packed runs, with exactly 5 / 2
   ``quant_matmul`` launches a step;
14. the launch layer (``launch/*``, ``optim/grad_compress``, the
   trainer's mesh functions, the EP MoE layer), on an NCCL process group
   of world size 1 (a ``FileStore`` in a temporary directory): 14.1
   ``launch.train.main`` (SmolLM-135M at full width, LightPE-1, 3 AdamW
   steps at 16 x 256) bitwise equal to the trainer driven directly with
   the same optimizer, schedule, seed and pipeline, with exactly 842
   ``fake_quant`` and 60 + 30 ``flash_attention`` launches a step (each
   layer's forward again in its recomputation); 14.2
   the same run on a (1, 1) mesh (``state_shardings_for``, the
   per-process pipeline, the dp mean an NCCL ``all_reduce``) bitwise
   equal to 14.1, saved at step 2 and resumed onto a fresh (1, 1) mesh,
   step 3 bitwise equal; 14.3 ``make_compressed_allreduce`` over NCCL on
   SmolLM-135M's gradients, every leaf: the codes of round(g32 / scale),
   |mean - g| <= scale / 2 and new_err == g32 - mean, timed beside the
   float32 all-reduce; 14.4 the EP MoE layer (``moe_ep_shard_map``) in
   phase 11.3's DeepSeek-MoE-16B (3 layers, its params and requests,
   FP32 preset in bfloat16) on the (1, 1) mesh, ``moe_apply``'s experts
   taken at its router near ties: the float32 payload held to
   ``moe_apply`` at phase 11.3's tolerance, the int8 payload to the
   float32 one at ``EP_INT8_TOL``, with a control at 0 that must fail;
   14.5 ``launch.serve.main`` (Gemma-3-1B at full width and depth,
   LightPE-1 packed then served dequantized), its tokens equal to a
   ``ServeEngine`` run on the same dequantized weights, with exactly 26
   ``flash_attention`` launches a step, tokens/s and peak memory;
15. the dry run (``launch/{op_analysis,dryrun}``): 15.1 the (1, 1) mesh
   step of SmolLM-135M at full width, LightPE-1, 16 x 256, AdamW, with
   each layer recomputed, and the same step with ``layers.remat`` the
   identity, from one seed: 1 + ``DRY_TIMED`` steps of each in turn,
   every one bitwise equal (loss, gradient norm, state), the first's
   peaks and the others' host-paced p50 beside each other (the cost of
   recomputation); then one step counted on the card by ``op_analysis``
   and the same step on a (1, 1) ``meta`` mesh: FLOPs, bytes, collective
   bytes by kind and launches a kernel equal, and the analyzer's launches
   those of the kernels' own counters, set to 0 just before; the step's
   temporary bytes within ``DRY_MEM_BAND`` of the growth of
   ``max_memory_allocated``; 15.2 Gemma-3-1B at full size, the
   ``decode_32k`` step with the batch cut to 8 (a 7.0 GB bfloat16 cache),
   the same equalities and band, its host-paced p50 and the device's
   busy time (``torch.profiler``) beside the bytes it reads and writes
   and its FLOPs at the card's rates; 15.3 every cell of
   ``launch/shapes.py`` x the ten configs, counted on ``meta`` by worker
   processes (no card) that start beside the kernels' build and stop
   from phase 1 to the end of 15.2: on a (1, 1) mesh held to
   ``tests/data/torch_dryrun_ref.json`` (FLOPs, each side without its
   matrix-vector part, at rtol 1e-9; argument bytes exact; every cell
   counted, the training cells of Gemma-2, Gemma-3 and Zamba2-7B too),
   and the pod16x16 table;
16. every family trains on the card (the backward kernel's sliding
   windows, soft-caps and head_dims 16 / 32 / 112 / 256): 16.1 the
   backward kernel at Gemma-3-1B's local and global layers (2 x 1024,
   4/1 heads, window 512), Gemma-2-9B's (4,608 tokens, 16/8 heads, window
   4,096, soft-cap 50, scale 1/16), Zamba2-7B's shared attention (32/32
   heads of 112) and the reduced head_dims 16 and 32, float32 and
   bfloat16, against the plain backward at phase 10.1's tolerances, two
   calls bitwise equal, timed beside the plain version and a library
   call's backward (SDPA with the window as a mask; with the soft-cap,
   ``flex_attention`` compiled), with its bound, head_dims 112 and 256
   on the wgmma backward (``csrc/flash_attention_bwd_wgmma.cu``) beside
   the times of the replaced mma.sync kernel as constants
   (``REPLACED_MS``); 16.2
   Gemma-3-1B (8 layers; LightPE-1, and FP32 numerics) and 16.3
   Gemma-2-9B (4 layers), Zamba2-7B (13 layers), RWKV6-1.6B (6 layers) and
   Whisper-medium (6 + 6 layers) at full width, LightPE-1, AdamW
   (``FAMILY_TRAIN``), their launches
   counted exactly (2 forwards and a
   backward an attention call a step; at head_dims 112 and 256 every one
   on the wgmma kernels), held to the same
   steps on the kernels' plain versions at ``TRAIN_LM_RTOL``, the step
   p50 and the peak memory; 16.4 the reduced configs at the new instances
   held to ``tests/data/torch_train_families_ref.json`` (the JAX
   package's steps) at ``TRAIN_LM_RTOL``, with a control (Gemma-2 with
   its attention detached) that must fail;
17. serving on an fp8 (float8_e4m3fn) K/V cache: 17.1 every kernel
   instance on e4m3 K and V (the split kernel at decode, the mma kernel
   at prefill, both built by ``csrc/flash_attention_fp8.cu``, and the
   wgmma kernel at 112-256) at Qwen3-32B's decode (130 and 512 keys) and
   prefill (4 x 130) on a 32,768-row cache, Gemma-3-1B's windowed layer,
   Zamba2-7B's shared attention and Whisper's decoder self-attention
   (float32 P), and decode_32k (batch 8, 16 replicated KV heads, 32,768
   keys) on peaked and on near-uniform logits, float32 and bfloat16 q,
   against the plain version (within ``FA_TOL`` plus one e4m3 step times
   |v| for each P at a rounding tie), two calls bitwise equal, the share
   of nonzero P codes printed (nonzero in every case but the near-uniform
   control, where both outputs are exactly 0), timed beside the plain
   version and the bound (decode_32k also beside the same kernel on a
   bfloat16 cache, its bound, and SDPA on the bfloat16 cache, not the
   same function); 17.2 Qwen3-32B at full width, 2 layers, on an fp8
   cache against ``tests/data/torch_fp8_ref.json`` (the JAX package's
   run on the same hashed weights and greedy tokens; a float32-cache
   control must miss it), then 4 layers, batch 8, a 32,768-row cache as
   the perf variants ``v1b_f8_cache_seqshard`` (dense float32 weights)
   and ``v3_f8_cache`` (int4 codes, 16 replicated KV heads) serve it,
   launches counted exactly and each run held to the same run on the
   kernels' plain versions, with step times, decode tokens/s and peak
   memory;
18. the tensor-parallel split of the decoder family: 18.1 two ranks of
   one ``model`` group, two processes on the one card over gloo (NCCL
   refuses two ranks on one GPU; the transport is printed): Gemma-3-1B
   trained as 16.2 (8 layers, 2 x 1,024, LightPE-1, 3 AdamW steps; 2 + 2
   q heads over the replicated KV head, the MLP and the 262,144-row tied
   vocabulary split), the same under FP32 in float32 (the sum order's
   noise floor) and a control that must fail (``q_norm`` / ``k_norm``
   not summed over the group), SmolLM-135M (its attention whole, the
   weight gradients over each rank's tokens) timed beside the plain
   whole-layer step, and Qwen3-32B served as 17.2's v3 (int4 codes, the
   16 replicated KV heads split 8 + 8 with the fp8 cache), each held to
   the same run on one rank with its launches a step and rank exactly
   the one rank's and every leaf equal on the two ranks, step ms and
   peak memory a rank beside; 18.2 the
   forward kernels on one KV head of a cache of eight read as a strided
   view (no copy), at pod16x16's local shapes (Qwen3-32B's 4 q heads at
   decode_32k and at prefill, Gemma-2-9B's 1 local-layer q head), and the
   backward at Qwen3-32B's training shape a rank, against the plain
   versions, timed;
19. the sequence-sharded cache: 19.1 two ranks of one ``model`` group on
   the one card over gloo (18.1's launcher), the cache's rows split
   between them where its KV heads do not divide the group: Gemma-3-1B
   at full width (8 of 26 layers; its q heads gathered for the
   attention) on a bfloat16 and an e4m3 cache and on int4 codes, and
   SmolLM-135M (8 layers, its attention whole), a prefill spanning both
   slices and decode steps, each held to the same run on one rank with
   its launches a rank exactly the one rank's, each attention launch a
   stats and a pass-2 launch; 19.2 the slice forms at pod16x16's local
   shapes (Qwen3-32B v1b_f8_cache_seqshard decode_32k in 16 slices of
   2,048 keys, and a prefill slice on the wgmma kernel), combined by
   ``layers.seq_attention`` on one thread a slice and held to the
   unsharded kernel and the plain version, one slice's launches timed;
20. the tensor-parallel split of the SSM and hybrid families: 20.1 two
   ranks of one ``model`` group on the one card over gloo (18.1's
   launcher): RWKV6-1.6B (4 of 24 layers) and Zamba2-7B (7 of 81: a group
   of 6 Mamba2 blocks, the shared block and the tail's first) at full
   width, each rank computing its heads of the time and channel mix, of
   each Mamba2 block and of the shared attention, trained 2 steps under
   LightPE-1 and FP32 and served on a float32 cache, each held to the same
   run on one rank (training within the larger of a fixed tolerance and
   twice the spread of that run's two twins, the embedding moved by one
   unit in the last place; a control with unsummed replicated leaves must
   miss) with its launches a step and rank exactly the one rank's and
   every leaf equal on the ranks; 20.2 the attention kernels at a
   pod16x16 rank's shapes of Zamba2-7B (decode_32k, prefill_32k's last
   4,096 queries, the backward at train_4k) and ``fake_quant`` on a rank's
   shards, against the plain versions, timed;
21. prints a ``{"kernels": [...]}`` line, a ``{"train": ...}`` line and,
   last, the device line.

Phases 3, 4, 8 and 9.1-9.5 launch ``fake_quant`` or no kernel: they run
while ``nvcc`` builds the other sources (their host times share the
cores); each phase's seconds are printed.

TF32 is off for matrix products and convolutions (``repro_torch`` sets
both flags at import): the reference tolerances need IEEE float32.

Any failed phase exits non-zero before the last line is printed.
"""

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REF = ROOT / "tests" / "data" / "torch_quickstart_ref.json"
SERVE_REF = ROOT / "tests" / "data" / "torch_serve_ref.json"
COEX_REF = ROOT / "tests" / "data" / "torch_coexplore_ref.json"
SCALE_REF = ROOT / "tests" / "data" / "torch_scale_ref.json"
TRAIN_REF = ROOT / "tests" / "data" / "torch_train_ref.json"
GEMMA_REF = ROOT / "tests" / "data" / "torch_gemma3_ref.json"
MOE_REF = ROOT / "tests" / "data" / "torch_moe_ref.json"
VARIANTS_REF = ROOT / "tests" / "data" / "torch_variants_ref.json"
SSM_REF = ROOT / "tests" / "data" / "torch_ssm_ref.json"
DRYRUN_REF = ROOT / "tests" / "data" / "torch_dryrun_ref.json"
SCALE_SHARDS = 4
SCALE_DEPTH = 2
KILL_AFTER = 40

# (R*S*C, K) of VGG-16/CIFAR-10's 15 layers, and two ragged shapes.
VGG16_SHAPES = [(27, 64), (576, 64), (576, 128), (1152, 128), (1152, 256),
                (2304, 256), (2304, 256), (2304, 512)] + [(4608, 512)] * 5 \
    + [(512, 512), (512, 10)]
RAGGED_SHAPES = [(300, 190), (1, 129)]
ACT_SHAPE = (4 * 130, 576)      # a prefill's activations, one scale
UNALIGNED = (190, 33)           # a view one element off 16 bytes
KERNEL_MODES = [("affine", 4), ("affine", 8), ("affine", 16), ("pow2", 8)]
KERNEL_TOL = 1e-6
H100_BYTES_PER_S = 3.35e12      # HBM3 of the H100 SXM (NVIDIA data sheet)
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores (same)
H100_BF16_FLOPS = 989e12        # bf16 tensor cores, dense (same)
SLEEP_CYCLES = 200_000_000      # ~0.1 s at the H100's ~1.98 GHz clock
WIDE_POINTS = 2 ** 20
WIDE_CHUNK = 65536

# Slice 2.  SmolLM-135M's projections (K, N): wq/wo, wk/wv, w_up/w_gate,
# w_down (each checked with float32 and bfloat16 x: the residual stream
# is bfloat16, the MLP's hidden float32); ragged shapes of the
# reference's kernel test.
QMM_SHAPES = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
QMM_RAGGED = [(37, 300, 190), (1, 512, 129), (200, 254, 64)]
QMM_EDGE_M = (1, 16, 17, 64)
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
QMM_MODES = ("int4", "pow2", "int8")
QMM_RTOL, QMM_ATOL = 1e-5, 1e-4         # tests/test_kernels.py:45
FA_TOL = 2e-5                           # tests/test_kernels.py:122
FA_DECODE_OFFSETS = (0, 1, 63, 135, 255)   # across the split boundaries
FA_DECODE_SQ = (1, 2)                       # the decode plan's Sq at G = 3
# (q type, K/V type, round_p): the served float32 path, and bfloat16 q
# with the engine's float32 cache (the model without packed weights)
FA_PATH_TYPES = [("float32", "float32", False), ("float32", "float32", True),
                 ("bfloat16", "float32", False), ("bfloat16", "float32", True)]
FA_RAGGED = [(100, 100, 32), (64, 256, 16), (1, 128, 64)]
# Logit tolerances of the serving runs against the JAX package (on the
# CPU the port is 0.033 / 0.026 from it in bfloat16, 2.8e-4 / 3.3e-6 in
# float32; bfloat16 rounding turns the order of float32 sums into ~0.04
# over 30 layers, and in float32 LightPE-1 also carries the few pow2 codes
# that sit at a log2 tie, which INT8 has none of).
SERVE_TOL = {"lightpe1": 0.1, "int8": 0.1, "lightpe1/float32": 2e-3,
             "int8/float32": 1e-4}
SERVE_LAUNCHES = {"quant_matmul": 12 * 30 * 7, "flash_attention": 12 * 30}
QUICKSTART_LAUNCHES = 5         # int16 1, lightpe1 1, lightpe2 2, int8 1
# Slice 5: the model on dense weights under QAT numerics, held to the JAX
# package's runs (``qat_modes`` of the serving reference), the comparison
# coupled across the batch (one activation scale for the whole batch).
# In bfloat16 the runs take the serving runs' 0.1.  In float32 LightPE-1
# cannot take their 2e-3: with 8-bit activations a code at a round(x / s)
# tie flips by one step of absmax / 127 when a float32 sum is taken in
# another order, and 30 layers carry it on; one float32 ulp on half the
# embedded tokens moves the card's LightPE-1 logits by up to 0.100
# (benchmarks/torch_qat_sensitivity.py).  So 0.125: above that, and below
# what the bfloat16 LightPE-1 run reads against the float32 reference
# (QAT_CONTROL, which must fail), so the limit still tells the two
# compute types apart.
QAT_TOL = {"int16": 0.1, "lightpe1": 0.1, "lightpe2": 0.1, "int8": 0.1,
           "lightpe1/float32": 0.125}
# fake_quant launches a projection a step: the weight and the activation
# (LightPE-2's weight takes two passes); 7 projections a layer and the head
QAT_PASSES = {"int16": 2, "lightpe1": 2, "lightpe2": 3, "int8": 2}
QAT_PROJECTIONS = 7
# the control: a run in the wrong compute type, held to the float32 run
QAT_CONTROL = ("lightpe1", "lightpe1/float32")
# Phase 3 at the shapes of phase 7 (SmolLM-135M): the projection weights
# and the tied head, float32, a scale a column; the activations of decode
# (4 rows) and prefill (4 x 130 rows), one scale, in both types.  1536 and
# 49152 columns pass a block's vector stride (1024 float32 elements), so
# the column counter wraps within a thread.
SMOLLM_WEIGHTS = [(576, 576), (576, 192), (576, 1536), (1536, 576),
                  (576, 49152)]
SMOLLM_ACTS = [(4, 576), (4, 1536), (520, 576), (520, 1536)]
# Phase 10: training at the example's settings (examples/torch_train_qat.py)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 256, 20
# the Figs. 5-6 run, cut from its defaults (300 steps, 2 trials: 67 s of
# the smoke): ResNet-8 on the CPU reads top-1 1.0 for every PE type after
# 150 steps of one trial (0.90 / 0.98 / 0.90 / 1.0 after 100), within the
# paper's story
FIGS56_STEPS, FIGS56_TRIALS = 150, 1
# Its constant learning rate keeps the loss spiking late in the run, so a
# card run whose sums fall in another order reads another table: with
# cuDNN's default (non-deterministic) convolutions LightPE-1 read top-1
# 0.43 / 1.0 / 1.0 in three runs of one seed (scripts/torch_cnn_repeat.py,
# NVIDIA H100 80GB HBM3, 700.00 W).  The port's convolutions are
# deterministic; the LightPE-1 step is run twice for FIGS56_REPEAT_STEPS
# steps from one seed and every leaf must be bitwise equal.
FIGS56_REPEAT_STEPS = 20
# LightPE-1: 211 projections x (w, x), and each layer's 210 again in its
# recomputation (``layers.remat``)
TRAIN_FQ_PER_STEP = (30 * 7 * 2 + 1) * 2
TRAIN_FWD_PER_LAYER = 2                # the forward and its recomputation
TRAIN_MIN_DROP = 0.5                   # mean of the last 3 losses vs first 3
RESUME_BATCH = 4
# The backward kernel's time at phase 10.1's training shapes before its
# tensor-core redesign: the CUDA-core kernel's chip run, NVIDIA H100 80GB
# HBM3, 700.00 W
CUDA_CORE_BWD_MS = {"train_f32": 0.6762, "train_bf16": 0.6682}
# the card's LM / CNN steps against tests/data/torch_train_ref.json
TRAIN_LM_RTOL = 1e-2
TRAIN_CNN_RTOL = 1e-2
# Phase 11.1: (name, b, sq, skv, hq, hkv, d, start, window, softcap,
# scale) of the windowed kernel: Gemma-3-1B's local layers (the serving
# run's 1024-row cache) and Gemma-2-9B's (its 4096 window passed by a
# 4608-token sequence), decode and prefill
WINDOW_SHAPES = [
    ("gemma3-1b decode", 4, 1, 1024, 4, 1, 256, 905, 512, 0.0, 0.0),
    ("gemma3-1b prefill", 4, 900, 1024, 4, 1, 256, 0, 512, 0.0, 0.0),
    ("gemma2-9b decode", 1, 1, 4608, 16, 8, 256, 4607, 4096, 50.0, 1 / 16),
    ("gemma2-9b prefill", 1, 4608, 4608, 16, 8, 256, 0, 4096, 50.0,
     1 / 16)]
# Phase 11.2: Gemma-3-1B's runs take the SmolLM-135M serving runs'
# tolerances (bfloat16 0.1, LightPE-1 float32 2e-3), on the reference's
# codes at the log2 ties
GEMMA_TOL = {"lightpe1": 0.1, "int8": 0.1, "lightpe1/float32": 2e-3}
GEMMA_PROJECTIONS = 7           # wq, wk, wv, wo, w_up, w_gate, w_down
# Phase 11.3: DeepSeek-MoE-16B in bfloat16, the reference's experts pinned
# at its router near ties.  The FP32 preset takes phase 7's 0.1.  Under
# QAT numerics in bfloat16 two correct runs sit ~0.1 apart: the port on
# the CPU (the kernels' plain versions, other float32 sum orders) reads
# 0.1011 (LightPE-1) and 0.1051 (INT8) against the reference
# (benchmarks/torch_router_noise.py --serve --device cpu), so 0.125.  The
# experts' fake quantization is held by check_expert_fake_quant, not by
# this limit: with the stacks quantized as one tensor the runs read
# 0.1058 / 0.1195 (--stack-as-one), inside it.
MOE_TOL = {"fp32": 0.1, "lightpe1": 0.125, "int8": 0.125}
# Phase 12: the perf variants and Whisper, held to the JAX package's runs
# in tests/data/torch_variants_ref.json at the serving runs' tolerances
# (bfloat16 0.1; float32 2e-3, LightPE-1's, here also for the dense
# float32 forward of 8,192 positions, whose attention sums run over up to
# 2,048 keys); training at phase 10's TRAIN_LM_RTOL
FLASH_TOL = {"float32": 2e-3, "bfloat16": 0.1}
WHISPER_TOL = {"fp32/dense": 0.1, "lightpe1": 0.1, "int8": 0.1,
               "lightpe1/float32": 2e-3}
# Phase 12.2: Gemma-3-1B's one KV head replicated to its 4 query heads
KV_REPLICATE_TO = 4
# The times of the kernels the wgmma kernels replaced, constants from
# this script's run of the tree before them on an NVIDIA H100 80GB HBM3
# at 700.00 W: the forward's split kernel at prefill (phases 11.1 with a
# float32 q, 12.6 and 13.1) and the mma.sync backward at head_dims 112
# and 256 (16.1).  Printed beside the new times for a reader; no record
# of this run holds them
REPLACED_MS = {
    "gemma3-1b prefill/float32": 1.3424, "gemma2-9b prefill/float32": 47.3663,
    "gemma3-1b block-local": 0.8781, "zamba2_prefill/float32": 0.2418,
    "gemma3_local_f32": 1.8313, "gemma3_global_f32": 2.4989,
    "gemma2_local_f32": 52.8045, "gemma2_global_f32": 53.2806,
    "gemma3_local_bf16": 1.1542, "gemma3_global_bf16": 1.5594,
    "gemma2_local_bf16": 34.6569, "gemma2_global_bf16": 35.0431,
    "zamba2_shared_f32": 0.6694, "zamba2_shared_bf16": 0.4676}
# Phase 12.6: (name, b, sq, skv, hq, hkv, d, causal, window) of the kernel
# alone at the new paths' shapes, float32 q, K, V, float32 P
VARIANT_SHAPES = [
    ("whisper encoder", 4, 1500, 1500, 16, 16, 64, False, 0),
    ("whisper cross prefill", 4, 8, 1500, 16, 16, 64, False, 0),
    ("whisper cross decode", 4, 1, 1500, 16, 16, 64, False, 0),
    ("gemma3-1b block-local", 2, 1024, 1024, 4, 1, 256, True, 512),
    ("smollm-135m attn_flash", 4, 2048, 2048, 9, 3, 64, True, 0)]


# Phase 13.1: (name, b, sq, skv, hq, hkv, d, start) of Zamba2-7B's shared
# attention at head_dim 112 on the engine's 256-row float32 cache: the
# prefill of 4 x 130 rows from position 0, and the first decode step (at
# position 130)
ZAMBA_ATTN_SHAPES = [("zamba2_prefill", 4, 130, 256, 32, 32, 112, 0),
                     ("zamba2_decode", 4, 1, 256, 32, 32, 112, 130)]
# Phase 13.2-13.3: RWKV6-1.6B and Zamba2-7B on dense float32 weights in
# bfloat16, at the cut depth against the JAX package and at full depth
# against the same run on the kernels' plain versions.  The FP32 preset
# takes phase 11.3's 0.1.  Under QAT numerics (compared coupled across the
# batch) phase 11.3's 0.125 does not hold two correct runs: at the cut
# depth the port on the CPU (the kernels' plain versions) reads 0.260 /
# 0.230 (RWKV6, LightPE-1 / INT8) and 0.462 / 0.259 (Zamba2) against the
# JAX package at the prefill (benchmarks/torch_ssm_noise.py --device cpu):
# float32 sums in another order flip bfloat16 roundings (one inside
# RWKV's time mix, where the CPU tests' pins cannot reach), and 8-bit
# activation codes carry each flip on.  So 0.75 there; the control (the
# LightPE-1 run held to the INT8 reference: 3.54 / 1.82 apart in the
# reference file) must fail it, and the QAT numerics themselves are held
# element by element by check_ssm_fake_quant.  INT8's own effect on
# RWKV6's logits (0.39 against the FP32 preset) is within that noise.
SSM_TOL = {"fp32": 0.1, "lightpe1": 0.75, "int8": 0.75}
SSM_CONTROL = ("lightpe1", "int8")
# At full depth against the kernels' plain versions: RWKV6 repeats them
# bit for bit (its one kernel, fake_quant, differs from its plain version
# in no element); Zamba2-7B's 13 attention launches differ from the plain
# attention by up to 1.3e-6 (13.1), which its 81 bfloat16 layers carry to
# 0.0965 under the FP32 preset (this script's reading on an NVIDIA H100
# 80GB HBM3 at 700 W), so 0.2 there; the QAT modes as above
SSM_FULL_TOL = {"fp32": 0.2, "lightpe1": 0.75, "int8": 0.75}
# Phase 13.4: the reduced models on LightPE-1 / INT8 codes in bfloat16, the
# serving runs' 0.1
SSM_PACKED_TOL = {"lightpe1": 0.1, "int8": 0.1}
# quant_matmul under a bfloat16 cast against its plain version: one
# bfloat16 step (the float32 sums run in another order before the result
# is rounded), and near zero, where a sum cancels, the float32 kernels'
# absolute tolerance
QMM_CAST_RTOL = 2.0 ** -7


def _replaced(key: str, ms: float) -> str:
    """The time of the kernel this one replaced (a constant of
    ``REPLACED_MS``, not timed in this run) and its ratio to this run's
    time, for the printed line; or nothing."""
    t = REPLACED_MS.get(key)
    return (f" (the replaced kernel, a constant: {t:.4f} ms, "
            f"{t / ms:.2f} x this)" if t else "")


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# The numpy weight draws of 11.2, 11.3 and 13.2-13.3 (the JAX package's
# references were written from them): made from phase 10 on by one thread
# of their own (numpy's draws release the GIL), beside the card's phases,
# and taken by ``numpy_draw`` where the phases used to draw
_DRAWS = {}


def prefetch_draws() -> None:
    """Start the numpy draws of 11.2, 11.3, 13.2 and 13.3 on a thread."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.configs import get
    from repro_torch.models import family_module
    jobs = []
    for path in (GEMMA_REF, MOE_REF):
        ref = json.loads(path.read_text())
        cfg = get(ref["config"])
        if "n_layers" in ref:
            cfg = cfg.replace(n_layers=ref["n_layers"])
        jobs.append((cfg, ref["param_seed"]))
    for ref in json.loads(SSM_REF.read_text())["dense"].values():
        jobs.append((get(ref["config"]).replace(n_layers=ref["n_layers"]),
                     ref["param_seed"]))
    pool = ThreadPoolExecutor(1)
    for cfg, seed in jobs:
        _DRAWS[(repr(cfg), seed)] = pool.submit(
            family_module(cfg).numpy_params, cfg, seed)
    pool.shutdown(wait=False)


def numpy_draw(mod, cfg, seed: int):
    """``mod.numpy_params(cfg, seed)``, the prefetched draw where
    ``prefetch_draws`` made it."""
    fut = _DRAWS.pop((repr(cfg), seed), None)
    return fut.result() if fut is not None else mod.numpy_params(cfg, seed)


_FLEX = []     # torch.compile(flex_attention), made at its first use
# a library call timed beside a kernel must compute its function: its
# float32 output against the plain version's (SDPA and flex_attention read
# ~1e-6)
LIBRARY_TOL = 1e-3


def flex_softcap(torch, sq, skv, start, window, softcap):
    """The library call on the soft-capped attention (phases 11.1 and
    16.1): ``flex_attention``, compiled as its users run it, with
    c * tanh(s / c) as its ``score_mod`` (s the scaled logit, as the
    kernels cap it) and the causal window as its block mask, GQA through
    ``enable_gqa``; ``f(q, k, v, scale)`` on (B, H, S, D) tensors.  The
    window is a tensor, so a global layer (a window past every key) runs
    the windowed layer's compiled kernels.  Timed beside the kernels; the
    port never calls it."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    if not _FLEX:
        # the timing calls reuse one forward's graph (retain_graph), which
        # a compiled backward with donated buffers refuses
        import torch._functorch.config as functorch_config
        functorch_config.donated_buffer = False
        _FLEX.append(torch.compile(flex_attention))
    win = torch.tensor(window or start + sq + skv, device="cuda")

    def mask_mod(b, h, i, j):
        return (j <= i + start) & (j > i + start - win)

    def score_mod(x, b, h, i, j):
        return softcap * torch.tanh(x / softcap)

    mask = create_block_mask(mask_mod, None, None, sq, skv, device="cuda")
    return lambda q, k, v, scale: _FLEX[0](
        q, k, v, score_mod=score_mod, block_mask=mask, scale=scale,
        enable_gqa=True)


def time_ms(torch, fn, reps: int = 5, warmup: int = 2,
            queued: bool = True) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events).

    ``queued``: the stream is held by a sleep kernel while the host queues
    all ``reps`` calls, so the events see device time only, without the
    gaps of a host slower than the device (the host-paced time is what
    ``queued=False`` gives).
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(torch, fn, flush, reps: int = 5):
    """Mean device milliseconds of ``fn()`` with the L2 cache flushed
    before each call (``flush`` is a buffer larger than the 50 MB L2,
    zeroed between the calls): sleep, flush, start, fn, end, queued so the
    events see the device only."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES // 10)
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def check_kernels(torch, dev):
    """Phase 3: fake_quant against its plain version, per tensor and in
    one grouped launch, in float32 and bfloat16, and its times."""
    from repro_torch.kernels.fake_quant import fake_quant, fake_quant_group
    from repro_torch.kernels.fake_quant.ref import (ref_fake_quant_affine,
                                                    ref_fake_quant_pow2)
    from repro_torch.quant.fake_quant import affine_scale, pow2_emax
    from repro_torch.quickstart import draw_weights

    base = draw_weights(VGG16_SHAPES + RAGGED_SHAPES + [ACT_SHAPE], seed=1,
                        device=dev)
    base[-1] = base[-1] * 30                       # activations: N(0, 3^2)
    flat = draw_weights([(UNALIGNED[0] * UNALIGNED[1] + 1,)], seed=2,
                        device=dev)[0]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    n_vgg = len(VGG16_SHAPES)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        ws = [w.to(dtype) for w in base]
        # a view one element off a 16-byte boundary (a scalar head)
        ws.append(flat.to(dtype)[1:].view(UNALIGNED))
        if ws[-1].data_ptr() % 16 == 0:
            fail("the view meant to be unaligned is aligned")
        vgg = ws[:n_vgg]
        elem = vgg[0].element_size()
        nbytes = sum(w.numel() * 2 * elem + w.shape[1] * elem for w in vgg)
        # divide, round, two compares, multiply an element
        bound, bound_by = bound_ms(nbytes, 5 * sum(w.numel() for w in vgg))
        for mode, bits in KERNEL_MODES:
            def scale(w, per_tensor):
                axis = None if per_tensor else 0
                s = (affine_scale(w, bits, axis) if mode == "affine"
                     else pow2_emax(w, axis))
                return s.reshape(1) if per_tensor else s[0]

            def plain(w, s):
                return (ref_fake_quant_affine(w, s, bits) if mode == "affine"
                        else ref_fake_quant_pow2(w, s))

            # the activations take one scale for the whole tensor, as in
            # the model; every other tensor one a column
            scales = [scale(w, per_tensor=(i == len(base) - 1))
                      for i, w in enumerate(ws)]
            before = fake_quant.launches
            single = [fake_quant(w, s, mode=mode, bits=bits)
                      for w, s in zip(ws, scales)]
            grouped = fake_quant_group(ws, scales, mode=mode, bits=bits)
            if fake_quant.launches - before != len(ws) + 1:
                fail(f"fake_quant {name} {mode}{bits}: "
                     f"{fake_quant.launches - before} launches, expected "
                     f"{len(ws) + 1}")
            want = [plain(w, s) for w, s in zip(ws, scales)]
            torch.cuda.synchronize()
            err, differing = 0.0, 0
            for got in (single, grouped):
                for g, w in zip(got, want):
                    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                        fail(f"fake_quant {name} {mode}{bits}: bad output "
                             f"{tuple(g.shape)}")
                    differing += int((g != w).sum())
                    err = max(err, float((g.float() - w.float()).abs().max()))
            if differing or err > KERNEL_TOL:
                fail(f"fake_quant {name} {mode}{bits}: {differing} elements "
                     f"differ from plain, max abs err {err} (tolerance "
                     f"{KERNEL_TOL})")
            pairs = list(zip(vgg, scales[:n_vgg]))
            group_fn = lambda: fake_quant_group(  # noqa: E731
                vgg, scales[:n_vgg], mode=mode, bits=bits)
            each_fn = lambda: [fake_quant(w, s, mode=mode, bits=bits)  # noqa: E731
                               for w, s in pairs]
            row = dict(
                dtype=name, mode=mode, bits=bits, differing=differing,
                max_abs_err=err, ms=time_ms(torch, group_fn),
                cold_ms=cold_ms(torch, group_fn, flush),
                per_weight_ms=time_ms(torch, each_fn),
                host_paced_ms=time_ms(torch, group_fn, queued=False),
                plain_ms=time_ms(torch, lambda: [plain(w, s)
                                                 for w, s in pairs]),
                library_ms=None, bound_ms=bound, bound_by=bound_by,
                bytes=nbytes)
            if mode == "affine" and dtype == torch.float32:
                qmax = 2 ** (bits - 1) - 1
                zps = [torch.zeros(w.shape[1], dtype=torch.int32, device=dev)
                       for w in vgg]
                row["library_ms"] = time_ms(torch, lambda: [
                    torch.fake_quantize_per_channel_affine(w, s, z, 1, -qmax,
                                                           qmax)
                    for (w, s), z in zip(pairs, zps)])
            rows[(name, mode, bits)] = row
            print(f"fake_quant {name} {mode}{bits}: {differing} differing, "
                  f"max_abs_err={err}; 15 VGG-16 weights: grouped "
                  f"{row['ms']:.4f} ms (L2 flushed {row['cold_ms']:.4f}, "
                  f"host-paced {row['host_paced_ms']:.4f}), per weight "
                  f"{row['per_weight_ms']:.4f} ms, plain {row['plain_ms']:.4f}"
                  f" ms, library {row['library_ms']} ms, bound "
                  f"{bound:.4f} ms ({nbytes} bytes)")
    return rows


def check_model_shapes(torch, dev):
    """Phase 3 at SmolLM-135M's QAT shapes: each tensor alone and all in
    one group, 0 differing elements from the plain version; returns the
    count of elements compared."""
    from repro_torch.kernels.fake_quant import fake_quant, fake_quant_group
    from repro_torch.kernels.fake_quant.ref import (ref_fake_quant_affine,
                                                    ref_fake_quant_pow2)
    from repro_torch.quant.fake_quant import affine_scale, pow2_emax
    from repro_torch.quickstart import draw_weights

    weights = draw_weights(SMOLLM_WEIGHTS, seed=3, device=dev)
    acts = [a * 30 for a in draw_weights(SMOLLM_ACTS, seed=4, device=dev)]
    compared = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        ts = (weights if dtype == torch.float32 else []) + [
            a.to(dtype) for a in acts]
        per_tensor = [False] * (len(ts) - len(acts)) + [True] * len(acts)
        for mode, bits in KERNEL_MODES:
            def scale(t, one):
                axis = None if one else 0
                s = (affine_scale(t, bits, axis) if mode == "affine"
                     else pow2_emax(t, axis))
                return s.reshape(1) if one else s[0]

            scales = [scale(t, one) for t, one in zip(ts, per_tensor)]
            single = [fake_quant(t, s, mode=mode, bits=bits)
                      for t, s in zip(ts, scales)]
            grouped = fake_quant_group(ts, scales, mode=mode, bits=bits)
            for t, s, a, b in zip(ts, scales, single, grouped):
                want = (ref_fake_quant_affine(t, s, bits) if mode == "affine"
                        else ref_fake_quant_pow2(t, s))
                for how, got in (("alone", a), ("grouped", b)):
                    differing = int((got != want).sum())
                    if got.shape != want.shape or differing:
                        fail(f"fake_quant {name} {mode}{bits} at "
                             f"{tuple(t.shape)} ({how}): {differing} "
                             f"elements differ from plain")
                    compared += want.numel()
    print(f"fake_quant at SmolLM-135M's shapes (weights {SMOLLM_WEIGHTS} "
          f"float32, activations {SMOLLM_ACTS} float32 and bfloat16, "
          f"{len(KERNEL_MODES)} modes, alone and grouped): 0 of {compared} "
          f"elements differ from plain")
    return compared


def run_slice(torch, dev):
    """Phase 4: the quickstart loop at full size, launches counted."""
    import numpy as np
    from repro_torch import quickstart
    from repro_torch.core import dse, workloads
    from repro_torch.core.arch import WIDE_SPACE, enumerate_space
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.quant import PE_TYPES

    fake_quant.launches = 0
    res = quickstart.run(max_points=None, presets=PE_TYPES, device=dev)
    launches = fake_quant.launches
    print(f"quickstart (cold): {json.dumps(res.timings)}")
    print(f"fake_quant launches on the path: {launches}")
    if launches != QUICKSTART_LAUNCHES:
        fail(f"the quickstart loop launched fake_quant {launches} times, "
             f"expected {QUICKSTART_LAUNCHES} (one grouped launch a "
             f"quantizing preset, two for LightPE-2)")

    print(f"PPA surrogate fit: R2 {json.dumps(res.r2)}")
    problems, notes = quickstart.compare(res, json.loads(REF.read_text()))
    for n in notes:
        print(f"tolerated: {n}")
    if problems:
        fail("quickstart differs from the JAX reference: " + "; ".join(problems))
    print(f"quickstart matches the JAX reference: front "
          f"{np.flatnonzero(res.front).tolist()}, best LightPE-1 "
          f"{res.best_config}")
    for pe, r in dse.report_pe_types(res.report).items():
        print(f"  {pe:9s} perf/area={r['norm_perf_per_area']:.4f}x "
              f"energy={r['norm_energy']:.4f}x (vs best INT16)")

    # step 6 outputs: finite, same shapes, LightPE-1 codes powers of two
    for p, ws in res.quantized.items():
        for w, q in zip(res.weights, ws):
            if q.shape != w.shape or not bool(torch.isfinite(q).all()):
                fail(f"{p}: bad fake-quantized weight {tuple(q.shape)}")
    for q in res.quantized["lightpe1"]:
        e = torch.log2(q.abs()[q != 0])
        if not bool((e == torch.round(e)).all()):
            fail("lightpe1 weights are not powers of two")

    # within the port: chunked == unchunked, tiled Pareto == sorted
    wl = workloads.vgg16("cifar10", device=dev)
    chunked = dse.evaluate_space(res.space, wl, chunk_size=4096)
    if not all(np.array_equal(a, b) for a, b in zip(chunked, res.oracle)):
        fail("chunked evaluate_space differs from the unchunked call")
    obj = torch.as_tensor(quickstart._objectives(res.oracle), device=dev)
    if not np.array_equal(dse.pareto_mask_tiled(obj).cpu().numpy(), res.front):
        fail("pareto_mask_tiled on the card differs from pareto_mask_2d")

    warm = quickstart.run(max_points=None, presets=PE_TYPES, device=dev)
    print(f"quickstart (warm): {json.dumps(warm.timings)}")

    # the sweep size users run: 2^20 points of WIDE_SPACE
    space = enumerate_space(WIDE_SPACE, max_points=WIDE_POINTS, seed=0,
                            device=dev)
    dse.evaluate_space(dse._slice_config(space, 0, WIDE_CHUNK), wl,
                       chunk_size=WIDE_CHUNK)  # warm-up chunk
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wide = dse.evaluate_space(space, wl, chunk_size=WIDE_CHUNK)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    if len(wide.energy_j) != WIDE_POINTS or not all(
            np.isfinite(c).all() for c in wide):
        fail("WIDE_SPACE sweep: wrong shape or non-finite columns")
    lanes = 4096
    cpu_space = type(space)(*[f.cpu() for f in
                              dse._slice_config(space, 0, lanes)])
    on_cpu = dse.evaluate_space(
        cpu_space, workloads.vgg16("cifar10", device="cpu"))
    for f, a, b in zip(wide._fields, wide, on_cpu):
        if not np.allclose(a[:lanes], b, rtol=quickstart.RTOL, atol=0):
            fail(f"WIDE_SPACE sweep: {f} differs from the CPU evaluation")
    n_front = int(np.asarray(dse.pareto_front(wide)).sum())
    print(f"WIDE_SPACE sweep: {WIDE_POINTS} points in {dt:.3f} s = "
          f"{WIDE_POINTS / dt:.0f} points/s, peak device memory "
          f"{peak_mb:.1f} MiB, front {n_front} points")
    return launches, warm.models


def device_ms(torch, chunks, reps: int = 5, sleep: int = SLEEP_CYCLES // 10):
    """Mean device milliseconds of calling every function in ``chunks``
    once.  Each chunk (a few hundred launches at most, within what the
    stream queues) is queued behind a short sleep kernel, so its events
    time the device's work back to back, without the gaps of a host
    slower than the device; the chunks' times are summed."""
    for fn in chunks:
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        for fn in chunks:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(sleep)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
    return total / reps


def bound_ms(nbytes: float, flops: float, peak: float = H100_F32_FLOPS):
    """(least milliseconds, what bounds it) at the H100 SXM's HBM rate and
    ``peak`` operations a second (default: the float32 CUDA-core rate)."""
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def kept_part_products(a_parts: int, b_parts: int) -> int:
    """The bf16 part products of one float32 product whose operands are
    ``a_parts`` and ``b_parts`` exact bf16 parts (3 for float32, 1 for
    bf16): the kept pairs of ``ref.PAIRS``, as the backward kernel forms
    them (6 for two float32 operands)."""
    from repro_torch.kernels.flash_attention.ref import PAIRS
    return sum(1 for pa, pb in PAIRS if pa < a_parts and pb < b_parts)


def attention_bound(b, hq, hkv, d, rows, q_bf16: bool, layers: int = 1):
    """(bound ms, what bounds it, bytes, half the pair products) of the
    served forward attention, ``layers`` calls alike.  ``rows``: each
    query's visible keys [lo, hi).  Bytes: q and the float32 out once, the
    keys the rows see once (K and V of the float32 cache).  Operations: 2
    D-long dot products a visible (query head, key) pair, as kept bf16
    part products on the tensor cores (``kept_part_products``): q . k one
    for bfloat16 q (K rounded to it) and 6 for float32 q and K; P V 6 (P
    and V in three parts each)."""
    sq = len(rows)
    visible = sum(hi - lo for lo, hi in rows)
    keys = max(hi for _, hi in rows) - min(lo for lo, _ in rows)
    nbytes = layers * (b * sq * hq * d * ((2 if q_bf16 else 4) + 4)
                       + 2 * 4 * b * keys * hkv * d)
    half = layers * 2 * b * hq * d * visible
    qk = kept_part_products(1, 1) if q_bf16 else kept_part_products(3, 3)
    bound, by = bound_ms(nbytes, half * (qk + kept_part_products(3, 3)),
                         H100_BF16_FLOPS)
    return bound, by, nbytes, half


def ptxas_summary(output: str) -> str:
    """Kernels, register range and spills from nvcc's ``-Xptxas -v``."""
    import re
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", output)]
    spills = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", output))
    if not regs:
        return "no ptxas report"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes of spills")


def check_serving_kernels(torch, dev):
    """Phase 5: quant_matmul and flash_attention against their plain
    versions on the same tensors on the card."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bh,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention import plan as fa_plan
    from repro_torch.kernels.flash_attention.ref import (ref_attention_gqa,
                                                         ref_flash_attention)
    from repro_torch.kernels.quant_matmul import launch_plan, quant_matmul
    from repro_torch.kernels.quant_matmul.ref import ref_quant_matmul
    from repro_torch.quant.pack import QUANTIZE
    from repro_torch.serve.check import BATCH_SLOTS, MAX_LEN, PROMPT_LENS

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    prefill_m = BATCH_SLOTS * max(PROMPT_LENS)
    cases = [(m, k, n) for k, n in QMM_SHAPES
             for m in (BATCH_SLOTS, prefill_m) + QMM_EDGE_M] + QMM_RAGGED
    qmm_err, variants = 0.0, set()

    def held(name, x, codes, scale, mode):
        nonlocal qmm_err
        got = quant_matmul(x, codes, scale, mode=mode)
        again = quant_matmul(x, codes, scale, mode=mode)
        want = ref_quant_matmul(x, codes, scale, mode)
        torch.cuda.synchronize()
        variants.add(launch_plan(x, codes, mode).variant)
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"quant_matmul {name}: bad output")
        if not torch.allclose(got, want, rtol=QMM_RTOL, atol=QMM_ATOL):
            fail(f"quant_matmul {name}: differs from plain by "
                 f"{float((got - want).abs().max())}")
        if not torch.equal(got, again):
            fail(f"quant_matmul {name}: two calls differ")
        qmm_err = max(qmm_err, float((got - want).abs().max()))

    for m, k, n in cases:
        w = randn(k, n) * 0.08
        for mode in QMM_MODES:
            codes, scale = QUANTIZE[mode](w)
            for x_type in (torch.float32, torch.bfloat16):
                held(f"{mode} {x_type} {(m, k, n)}", randn(m, k).to(x_type),
                     codes, scale, mode)
    # a layer's view into stacked codes, 8 bytes off a 16-byte boundary
    stack, stack_scale = QUANTIZE["pow2"](randn(2, 574, 72) * 0.08)
    if stack[1].data_ptr() % 16 == 0:
        fail("the layer view meant to be unaligned is aligned")
    for m in (BATCH_SLOTS, prefill_m):
        held(f"pow2 layer view M={m}", randn(m, 574), stack[1], stack_scale[1],
             "pow2")
    print(f"quant_matmul vs plain: {len(cases)} shapes x {len(QMM_MODES)} "
          f"modes x 2 x types and an unaligned layer view, variants "
          f"{sorted(variants)}, max_abs_err={qmm_err} (tolerance rtol "
          f"{QMM_RTOL} / atol {QMM_ATOL}); two calls bitwise equal")
    # the cast repair: x and each dequantized weight rounded to bfloat16,
    # a bfloat16 result, in both variants and all three modes
    cast = dict(shapes=0, steps=0, max_abs_err=0.0, variants=set())
    for m, k, n in [(BATCH_SLOTS, 576, 576), (prefill_m, 576, 1536),
                    (1, 512, 129), (17, 254, 64), (200, 254, 64)]:
        w = randn(k, n) * 0.08
        x = randn(m, k)
        for mode in QMM_MODES:
            codes, scale = QUANTIZE[mode](w)
            got = quant_matmul(x, codes, scale, mode=mode, cast=torch.bfloat16)
            again = quant_matmul(x, codes, scale, mode=mode,
                                 cast=torch.bfloat16)
            want = ref_quant_matmul(x, codes, scale, mode, torch.bfloat16)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            limit = QMM_CAST_RTOL * want.float().abs() + QMM_ATOL
            if got.dtype != torch.bfloat16 or not torch.equal(got, again) \
                    or not bool(torch.isfinite(got.float()).all()) \
                    or bool((diff > limit).any()):
                fail(f"quant_matmul {mode} {(m, k, n)} under a bfloat16 "
                     f"cast: {got.dtype}, {int((diff > limit).sum())} "
                     f"elements past rtol {QMM_CAST_RTOL} / atol "
                     f"{QMM_ATOL}, bitwise repeat {torch.equal(got, again)}")
            cast["shapes"] += 1
            cast["steps"] += int((got != want).sum())
            cast["max_abs_err"] = max(cast["max_abs_err"],
                                      float(diff.max()))
            cast["variants"].add(launch_plan(x.to(torch.bfloat16), codes,
                                             mode).variant)
    cast["variants"] = sorted(cast["variants"])
    print(f"quant_matmul under a bfloat16 cast vs plain: {cast['shapes']} "
          f"shape-modes, variants {cast['variants']}, {cast['steps']} "
          f"elements differ, max_abs_err={cast['max_abs_err']:.3g} "
          f"(tolerance rtol {QMM_CAST_RTOL} / atol {QMM_ATOL}); two calls "
          f"bitwise equal")

    fa_err = 0.0

    def held(name, got, want):
        nonlocal fa_err
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not bool(torch.isfinite(got).all()) or err > FA_TOL:
            fail(f"flash_attention {name}: differs from plain by {err}")
        fa_err = max(fa_err, err)

    b, hq, hkv, d = BATCH_SLOTS, 9, 3, 64
    fa_cases = [(max(PROMPT_LENS), 0)] + [
        (sq, min(o, MAX_LEN - sq)) for sq in FA_DECODE_SQ
        for o in FA_DECODE_OFFSETS]
    plans = set()
    for q_name, kv_name, round_p in FA_PATH_TYPES:
        q_type, kv_type = getattr(torch, q_name), getattr(torch, kv_name)
        for sq, off in fa_cases:
            q = randn(b, sq, hq, d).to(q_type)
            k, v = (randn(b, MAX_LEN, hkv, d).to(kv_type) for _ in range(2))
            start = torch.full((b,), off, dtype=torch.int32, device=dev)
            name = f"gqa {q_name} q, {kv_name} K/V, round_p={round_p}, " \
                   f"Sq={sq} offset={off}"
            got = flash_attention_gqa(q, k, v, start, round_p=round_p)
            again = flash_attention_gqa(q, k, v, start, round_p=round_p)
            held(name, got, ref_attention_gqa(q, k, v, start,
                                              round_p=round_p))
            if not torch.equal(got, again):
                fail(f"flash_attention {name}: two calls differ")
            plans.add(fa_plan(b, sq, MAX_LEN, hq, hkv, d,
                              q_type == torch.bfloat16).variant)
    for sq, skv, dh in FA_RAGGED:
        q, k, v = randn(2, 2, sq, dh), randn(2, 2, skv, dh), randn(2, 2, skv, dh)
        got = flash_attention_bh(q, k, v)
        want = torch.stack([torch.stack([ref_flash_attention(q[i, j], k[i, j],
                                                             v[i, j])
                                         for j in range(2)]) for i in range(2)])
        held(f"bh {(sq, skv, dh)}", got, want)
    q, k, v = randn(128, 32), randn(128, 32), randn(128, 32)
    held("non-causal", flash_attention(q, k, v, causal=False),
         ref_flash_attention(q, k, v, causal=False))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    held("bfloat16", flash_attention(qb, kb, vb),
         ref_flash_attention(qb, kb, vb))
    print(f"flash_attention vs plain: prefill, decode (Sq {FA_DECODE_SQ}) at "
          f"offsets {FA_DECODE_OFFSETS}, GQA {hq}/{hkv}, types "
          f"{FA_PATH_TYPES}, variants {sorted(plans)}; ragged, non-causal, "
          f"bf16: max_abs_err={fa_err} (tolerance {FA_TOL}); two calls "
          f"bitwise equal")
    return qmm_err, fa_err, cast


def time_serving_kernels(torch, dev, cfg, packed, index):
    """The two kernels' device times for one step of the served model
    (its own LightPE-1 codes, all 30 layers) beside their plain versions,
    a library call and the bound; ``flash_attention`` with the served
    float32 q and again with bfloat16 q, on the float32 cache.  Decode:
    M = 4 rows against a cache filled to ``index``; prefill: M = 4 * 130
    rows from position 0.
    Each bound is the bytes or the bf16 tensor rate (a float32 operand
    as three exact bf16 parts), the float32 CUDA-core bound of the
    kernels' first versions beside it; ``quant_matmul``'s decode step is
    also timed per projection."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.kernels.flash_attention import plan as fa_plan
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    from repro_torch.kernels.quant_matmul import launch_plan, quant_matmul
    from repro_torch.kernels.quant_matmul.ref import ref_quant_matmul
    from repro_torch.quant.pack import dequantize_pow2
    from repro_torch.serve.check import BATCH_SLOTS, MAX_LEN, PROMPT_LENS

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(4)
    lay = packed["layers"]
    # (packed leaf, the x type it takes on the path)
    projections = [(lay["attn"][n], torch.bfloat16) for n in
                   ("wq", "wk", "wv", "wo")] + [
        (lay["mlp"]["w_up"], torch.bfloat16),
        (lay["mlp"]["w_gate"], torch.bfloat16),
        (lay["mlp"]["w_down"], torch.float32)]
    qmm, fa = {}, {}
    s_prefill = max(PROMPT_LENS)
    for phase, m in (("decode", BATCH_SLOTS), ("prefill", BATCH_SLOTS * s_prefill)):
        calls, nbytes, flops, tc_flops = [], 0, 0, 0
        for i in range(cfg.n_layers):
            for leaf, x_type in projections:
                codes, scale = leaf["codes__pow2"][i], leaf["scale"][i]
                k, n = codes.shape[0] * 2, codes.shape[1]
                x = torch.randn((m, k), generator=gen, device=dev).to(x_type)
                calls.append((x, codes, scale))
                nbytes += (codes.numel() + scale.numel() * 4
                           + x.numel() * x.element_size() + m * n * 4)
                flops += 2 * m * k * n
                tc_flops += 2 * m * k * n * (3 if x_type == torch.float32
                                             else 1)
        dense = [(x.float(), dequantize_pow2(c, s)) for x, c, s in calls]
        kernel_ms = device_ms(torch, [lambda: [
            quant_matmul(x, c, s, mode="pow2") for x, c, s in calls]])
        per_projection = None
        if phase == "decode":   # calls are layer-major: projection j at j::7
            per_projection = {name: device_ms(torch, [lambda j=j: [
                quant_matmul(x, c, s, mode="pow2")
                for x, c, s in calls[j::len(projections)]]])
                for j, name in enumerate(PROJECTIONS)}
        plain_ms = device_ms(torch, [
            (lambda part=calls[j:j + 21]: [ref_quant_matmul(x, c, s, "pow2")
                                           for x, c, s in part])
            for j in range(0, len(calls), 21)])
        library_ms = device_ms(torch, [lambda: [torch.matmul(x, w)
                                                for x, w in dense]])
        bound, by = bound_ms(nbytes, tc_flops, H100_BF16_FLOPS)
        bound_f32 = bound_ms(nbytes, flops)[0]
        variant = sorted({launch_plan(x, c, "pow2").variant
                          for x, c, _ in calls})
        qmm[phase] = dict(ms=kernel_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound, bound_by=by,
                          bound_f32_ms=bound_f32, launches=len(calls),
                          bytes=nbytes, flops=flops, tc_flops=tc_flops,
                          variant="/".join(variant),
                          per_projection_ms=per_projection)
        del dense

    b, hq, hkv, d = BATCH_SLOTS, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    # "float32": the served path (packed weights give float32 q, and the
    # engine's cache is float32); "bf16_q": bfloat16 q on the same cache
    # (the model on bfloat16 weights)
    fa_bf16 = {}
    for q_name, rows in (("float32", fa), ("bfloat16", fa_bf16)):
        q_type = getattr(torch, q_name)
        for phase, sq, start in (("decode", 1, index),
                                 ("prefill", s_prefill, 0)):
            q = torch.randn((cfg.n_layers, b, sq, hq, d), generator=gen,
                            device=dev).to(q_type)
            kv = torch.randn((2, cfg.n_layers, b, MAX_LEN, hkv, d),
                             generator=gen, device=dev)
            st = torch.full((b,), start, dtype=torch.int32, device=dev)
            qpos = start + torch.arange(sq, device=dev)
            mask = torch.arange(MAX_LEN, device=dev)[None, :] <= qpos[:, None]
            kernel_ms = device_ms(torch, [lambda: [
                flash_attention_gqa(q[i], kv[0, i], kv[1, i], st,
                                    round_p=True)
                for i in range(cfg.n_layers)]])
            plain_ms = device_ms(torch, [lambda: [
                ref_attention_gqa(q[i], kv[0, i], kv[1, i], st, round_p=True)
                for i in range(cfg.n_layers)]])
            library_ms = None
            if q_type == torch.float32:   # one call of the same function
                # SDPA's layout (B, H, S, D), made before the timing
                tq, tk, tv = (t.transpose(-2, -3).contiguous()
                              for t in (q, kv[0], kv[1]))
                library_ms = device_ms(torch, [lambda: [
                    sdpa(tq[i], tk[i], tv[i], attn_mask=mask,
                         enable_gqa=True) for i in range(cfg.n_layers)]])
            # the keys up to the last query's position (the kernel skips
            # the rest); the float32 CUDA-core bound stands beside it
            bound, by, nbytes, half = attention_bound(
                b, hq, hkv, d, [(0, min(MAX_LEN, start + i + 1))
                                for i in range(sq)],
                q_type == torch.bfloat16, cfg.n_layers)
            qk_peak = (H100_BF16_FLOPS if q_type == torch.bfloat16
                       else H100_F32_FLOPS)
            bound_f32 = bound_ms(nbytes, half * H100_F32_FLOPS / qk_peak
                                 + half)[0]
            rows[phase] = dict(
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by=by, bound_f32_ms=bound_f32,
                launches=cfg.n_layers,
                start=start, q_rows=sq, q_type=q_name, kv_type="float32",
                variant=fa_plan(b, sq, MAX_LEN, hq, hkv, d,
                                q_type == torch.bfloat16).variant)
    for name, rows in (("quant_matmul", qmm), ("flash_attention", fa),
                       ("flash_attention bf16 q", fa_bf16)):
        for phase, r in rows.items():
            extra = (f"; {r['variant']}, float32 CUDA-core bound "
                     f"{r['bound_f32_ms']:.4f} ms")
            if name != "quant_matmul":
                extra += f", q {r['q_type']}, K/V {r['kv_type']}"
            print(f"{name} {phase} step ({r['launches']} launches): kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}){extra}")
    print("quant_matmul decode step per projection (30 launches each): "
          + ", ".join(f"{k} {v:.4f} ms"
                      for k, v in qmm["decode"]["per_projection_ms"].items()))
    fa["bf16_q"] = fa_bf16
    return qmm, fa


def run_serving(torch, dev):
    """Phase 6: SmolLM-135M served on packed weights at full width, held
    to the JAX package's runs; returns the launch counts of the LightPE-1
    4 x 12 run, the kernel times and the step numbers."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import family_module
    from repro_torch.serve import (ServeEngine, check, packed_bytes,
                                   quantize_params)

    ref = json.loads(SERVE_REF.read_text())
    cfg = get(ref["config"])
    mod = family_module(cfg)
    t0 = time.perf_counter()
    params = convert.params_from_numpy(mod.numpy_params(cfg, ref["param_seed"]),
                                       dev)
    packs = {pe: quantize_params(params, pe, min_size=ref["min_size"])
             for pe in sorted({m["pe_type"] for m in ref["modes"].values()})}
    torch.cuda.synchronize()
    print(f"serving: {cfg.name} at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads, vocab "
          f"{cfg.vocab}); weights drawn and packed in "
          f"{time.perf_counter() - t0:.2f} s; dense {ref['dense_bytes']} B")

    def to_numpy(t):
        return t.float().cpu().numpy()

    prompts = [np.array(p) for p in ref["prompts"]]
    reuse = [np.array(p) for p in ref["reuse_prompts"]]
    launches = None
    for key, m in ref["modes"].items():
        packed = packs[m["pe_type"]]
        if packed_bytes(packed) != m["packed_bytes"]:
            fail(f"{key}: packed_bytes {packed_bytes(packed)} != the JAX "
                 f"package's {m['packed_bytes']}")
        run_cfg = cfg.replace(dtype=m["dtype"])

        def engine():
            return ServeEngine(run_cfg, mod, packed, ref["batch_slots"],
                               ref["max_len"])

        quant_matmul.launches = 0
        flash_attention.launches = 0
        got = check.record(engine(), prompts, ref["max_new"], to_numpy)
        counts = {"quant_matmul": quant_matmul.launches,
                  "flash_attention": flash_attention.launches}
        if counts != SERVE_LAUNCHES:
            fail(f"{key}: launches {counts} on the 4 x {ref['max_new']} run, "
                 f"expected {SERVE_LAUNCHES}")
        if key == "lightpe1":
            launches = counts
        runs = [("run4", got)]
        if "run6" in m:
            runs.append(("run6", check.record(engine(), reuse,
                                              ref["reuse_max_new"], to_numpy)))
        for name, rec in runs:
            problems, notes = check.compare(rec, m[name], SERVE_TOL[key])
            for note in notes:
                print(f"  tolerated ({key} {name}): {note}")
            if problems:
                fail(f"{key} {name} differs from the JAX reference: "
                     + "; ".join(problems))
            print(f"{key} {name}: matches the JAX reference (max logit err "
                  f"{check.max_logit_err(rec, m[name]):.3g}, tolerance "
                  f"{SERVE_TOL[key]}); tokens of request 0: {rec['tokens'][0]}")
    if launches is None:
        fail("the reference has no lightpe1 run")
    print(f"launches on the LightPE-1 4 x {ref['max_new']} run: {launches}")

    # the served default (LightPE-1 codes, bfloat16), warm, timed per step
    eng = ServeEngine(cfg, mod, packs["lightpe1"], ref["batch_slots"],
                      ref["max_len"])
    steps = {"prefill": [], "decode": []}

    def timed(name, fn):
        def step(p, t, c):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(p, t, c)
            torch.cuda.synchronize()
            steps[name].append(time.perf_counter() - t1)
            return out
        return step

    eng._prefill = timed("prefill", eng._prefill)
    eng._decode = timed("decode", eng._decode)
    gc.collect()   # the peak counts what is alive, garbage included
    base = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    reqs = [eng.submit(p, max_new=ref["max_new"]) for p in prompts]
    eng.run()
    wall = time.perf_counter() - t1
    tokens = sum(len(r.out) for r in reqs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    numbers = dict(prefill_ms=steps["prefill"][0] * 1e3,
                   decode_ms=float(np.mean(steps["decode"])) * 1e3,
                   tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
                   peak_mib=peak, base_mib=base)
    print(f"serving lightpe1 (warm): prefill {numbers['prefill_ms']:.3f} ms "
          f"(4 x {max(len(p) for p in prompts)} tokens), decode "
          f"{numbers['decode_ms']:.3f} ms/step, {tokens} tokens in "
          f"{wall:.3f} s = {numbers['tokens_per_s']:.1f} tokens/s, peak "
          f"device memory {peak:.1f} MiB ({base:.1f} MiB before the run)")
    qmm, fa = time_serving_kernels(torch, dev, cfg, packs["lightpe1"],
                                   max(len(p) for p in prompts) + 5)
    return launches, qmm, fa, numbers


def run_qat_serving(torch, dev):
    """Phase 7: SmolLM-135M at full width on its dense numpy-drawn weights
    under the QAT numerics of every quantizing PE type (fake-quantized
    float32 weights, activations in the compute type: bfloat16 reaches
    fake_quant), served by ``ServeEngine`` (4 prompts in 4 slots) and held
    to the JAX package's runs; fake_quant launches counted per run."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs import get
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.models import family_module
    from repro_torch.serve import ServeEngine, check

    ref = json.loads(SERVE_REF.read_text())
    cfg = get(ref["config"])
    mod = family_module(cfg)
    params = convert.params_from_numpy(mod.numpy_params(cfg, ref["param_seed"]),
                                       dev)
    prompts = [np.array(p) for p in ref["prompts"]]
    runs, records = {}, {}
    for key, m in ref["qat_modes"].items():
        run_cfg = cfg.replace(pe_type=m["pe_type"], dtype=m["dtype"])
        eng = ServeEngine(run_cfg, mod, params, ref["batch_slots"],
                          ref["max_len"])
        fake_quant.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = check.record(eng, prompts, ref["max_new"],
                           lambda t: t.float().cpu().numpy())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fake_quant.launches
        want = ref["max_new"] * (cfg.n_layers * QAT_PROJECTIONS + 1) \
            * QAT_PASSES[m["pe_type"]]
        if launches != want:
            fail(f"qat {key}: the run launched fake_quant {launches} times, "
                 f"expected {want}")
        problems, notes = check.compare(rec, m["run4"], QAT_TOL[key],
                                        coupled=True)
        for note in notes:
            print(f"  tolerated (qat {key}): {note}")
        if problems:
            fail(f"qat {key} differs from the JAX reference: "
                 + "; ".join(problems))
        err = check.max_logit_err(rec, m["run4"], coupled=True)
        steps = check.compared_steps(rec, m["run4"], coupled=True)
        runs[key] = dict(fake_quant_launches=launches, wall_s=wall,
                         max_logit_err=err, tolerance=QAT_TOL[key],
                         steps_compared=steps, tolerated=notes)
        records[key] = rec
        print(f"qat {key}: matches the JAX reference (max logit err "
              f"{err:.3g}, tolerance {QAT_TOL[key]}, steps compared "
              f"{steps} of {ref['max_new']}, {len(notes)} notes); "
              f"{launches} fake_quant launches, {wall:.3f} s for 4 x "
              f"{ref['max_new']} tokens; tokens of request 0: "
              f"{rec['tokens'][0]}")

    # the control: bfloat16 numerics held to the float32 reference must
    # not pass at the float32 mode's tolerance
    ran, against = QAT_CONTROL
    want = ref["qat_modes"][against]["run4"]
    problems, _ = check.compare(records[ran], want, QAT_TOL[against],
                                coupled=True)
    err = check.max_logit_err(records[ran], want, coupled=True)
    steps = check.compared_steps(records[ran], want, coupled=True)
    runs["control"] = dict(run=ran, reference=against, max_logit_err=err,
                           tolerance=QAT_TOL[against], steps_compared=steps,
                           problems=problems)
    print(f"qat control: the {ran} run held to the {against} reference: max "
          f"logit err {err:.3g} (tolerance {QAT_TOL[against]}), steps "
          f"compared {steps}; {len(problems)} problems")
    if not problems:
        fail(f"qat control: the {ran} run passes against the {against} "
             f"reference at {QAT_TOL[against]}, so that tolerance cannot "
             f"tell the two compute types apart")
    return runs


def run_coexplore(torch, dev, surrogate):
    """Phase 8: the joint co-exploration walks at full size, held to the
    JAX package's results and to the port's bitwise contracts."""
    import numpy as np
    from repro_torch import coexplore_check as check
    from repro_torch.core import coexplore
    from repro_torch.core.constraints import Budget

    ref = json.loads(COEX_REF.read_text())
    models = coexplore.default_model_set(device=dev)
    if [m.name for m in models] != ref["models"]:
        fail(f"default_model_set {[m.name for m in models]} != reference")
    if not np.array_equal(coexplore.accuracy_matrix(models),
                          np.asarray(ref["accuracy_matrix"])):
        fail("the accuracy matrix differs from the JAX reference")
    walks = {}
    card = card_line()

    def walk(tag, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        front = coexplore.coexplore_front(models, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = front.points_evaluated
        walks[tag] = dict(points=n, wall_s=dt, points_per_s=n / dt,
                          front=len(front.archive))
        print(f"coexplore {tag}: {n} joint points in {dt:.3f} s = "
              f"{n / dt:.0f} points/s, front {len(front.archive)} ({card})")
        return front

    def held(tag, front, run):
        problems, notes = check.compare(
            check.summary(front, coexplore.coexplore_report(front)),
            ref["runs"][run])
        for n in notes:
            print(f"tolerated: {tag}: {n}")
        if problems:
            fail(f"coexplore {tag} differs from the JAX reference: "
                 + "; ".join(problems))
        print(f"coexplore {tag} matches the JAX reference ({run})")

    def same(tag, a, b):
        diff = check.identical(a, b)
        if diff:
            fail(f"coexplore {tag} differ: " + "; ".join(diff))
        print(f"coexplore {tag}: bitwise equal")

    mixed = walk("mixed")
    held("mixed", mixed, "unconstrained")
    claim = coexplore.lightpe_claim(mixed)
    oks = [v["ok"] for v in claim["per_model"].values()]
    print(f"LightPE claim holds for {sum(o is True for o in oks)} of "
          f"{len(oks)} models; front by PE type "
          f"{coexplore.coexplore_report(mixed)['front_counts']['by_pe_type']}")
    same("mixed / per-model", mixed, walk("per-model", mix_models=False))
    area = Budget(area_mm2=0.9)
    pruned = walk("area<=0.9 two-stage", budget=area)
    held("area<=0.9 two-stage", pruned, "area_0.9")
    print(f"area<=0.9: {pruned.budget_stats}")
    same("area<=0.9 two-stage / single-stage", pruned,
         walk("area<=0.9 single-stage", budget=area, prune=False))
    spec = check.RUNS["budget_4500"]
    sub = walk("4500 area<=2 power<=250", max_points=spec["max_points"],
               budget=Budget(**spec["budget"]))
    held("4500 area<=2 power<=250", sub, "budget_4500")
    print(f"4500 area<=2 power<=250: {sub.budget_stats}")
    same("surrogate mixed / per-model",
         walk("surrogate 4500 mixed", surrogate=surrogate,
              max_points=check.SUBSAMPLE),
         walk("surrogate 4500 per-model", surrogate=surrogate,
              max_points=check.SUBSAMPLE, mix_models=False))
    return walks, dict(mixed=mixed, pruned=pruned)


def run_scale(torch, dev, fronts):
    """Phase 9: DSE at scale (sharded, checkpointed, searched and served
    walks, telemetry), held to phase 8's walks, to the port's bitwise
    contracts and to ``tests/data/torch_scale_ref.json``."""
    import csv
    import itertools
    import tempfile

    import numpy as np
    from repro_torch import coexplore_check as check
    from repro_torch import scale_check as S
    from repro_torch.core import coexplore, dse, search, workloads
    from repro_torch.core.arch import (DEFAULT_SPACE, MAPPED_SPACE,
                                       WIDE_SPACE)
    from repro_torch.core.constraints import Budget
    from repro_torch.obs import (Tracer, build_sweep_report, chrome_trace,
                                 trace_lanes)
    from repro_torch.serve import FrontCache, FrontServer

    ref = json.loads(SCALE_REF.read_text())
    models = coexplore.default_model_set(device=dev)
    if [m.name for m in models] != ref["models"]:
        fail(f"default_model_set {[m.name for m in models]} != reference")
    card = card_line()
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_scale_"))

    def timed(tag, fn, points=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = points(res) if points is not None else res.points_evaluated
        out[tag] = dict(points=n, wall_s=dt, points_per_s=n / dt)
        print(f"scale {tag}: {n} points in {dt:.3f} s = {n / dt:.0f} "
              f"points/s ({card})")
        return res

    def same(tag, a, b, rows=False):
        diff = check.identical(a, b)
        if rows and not diff and not (
                np.array_equal(a.archive.indices, b.archive.indices)
                and np.array_equal(a.archive.objectives,
                                   b.archive.objectives)):
            diff = ["row order"]
        if diff:
            fail(f"scale {tag} differ: " + "; ".join(diff))
        print(f"scale {tag}: bitwise equal" + (", row order included"
                                               if rows else ""))

    # 1. the sharded joint walk with telemetry, against phase 8's walks
    shard_kw = dict(shards=SCALE_SHARDS, pipeline_depth=SCALE_DEPTH)
    tr = Tracer(rss_interval_s=0.25)
    sharded = timed("sharded joint walk", lambda: coexplore.coexplore_front(
        models, telemetry=tr, **shard_kw))
    wall = out["sharded joint walk"]["wall_s"]
    tr.close()
    same("sharded (4) / phase 8 mixed", sharded, fronts["mixed"])
    if coexplore.lightpe_claim(sharded) != coexplore.lightpe_claim(
            fronts["mixed"]):
        fail("scale: the sharded walk's LightPE claim differs from phase 8's")
    lanes = sorted(k for k in trace_lanes(chrome_trace(tr))
                   if k.startswith("shard"))
    if lanes != [f"shard{i}" for i in range(SCALE_SHARDS)]:
        fail(f"scale: Chrome trace lanes {lanes}, expected "
             f"{SCALE_SHARDS} shard lanes")
    report = build_sweep_report(tr, wall_s=wall)
    phases = {k: report.attribution.get(k, {}).get("seconds", 0.0)
              for k in ("decode", "dispatch", "device_wait", "archive")}
    if any(v > wall for v in phases.values()) or \
            sum(phases.values()) > wall * 1.05:
        fail(f"scale: report phases {phases} do not fit in the wall time "
             f"{wall:.3f} s")
    out["sharded joint walk"].update(
        report={k: dict(seconds=v["seconds"], share=v["share"],
                        count=v["count"])
                for k, v in report.attribution.items()},
        coverage=report.coverage, n_compiles=report.n_compiles,
        lanes=len(lanes))
    print(f"scale sharded joint walk report (trace lanes {lanes}):")
    print(report.render())
    area = Budget(area_mm2=0.9)
    pruned = timed("sharded area<=0.9 two-stage",
                   lambda: coexplore.coexplore_front(models, budget=area,
                                                     **shard_kw))
    same("sharded area<=0.9 / phase 8", pruned, fronts["pruned"])
    st = pruned.budget_stats
    if (st.feasible, st.pruned) != (60_216, 290_784):
        fail(f"scale: sharded area<=0.9 feasible/pruned {st.feasible}/"
             f"{st.pruned}, expected 60216/290784")
    print(f"scale sharded area<=0.9: {st}")

    # 2. kill and resume from the checkpoint
    ck = str(tmp / "joint")
    part = timed("killed after 40 chunks", lambda: coexplore.coexplore_front(
        models, checkpoint_dir=ck, max_chunks=KILL_AFTER, **shard_kw))
    resumed = timed("resumed", lambda: coexplore.coexplore_front(
        models, checkpoint_dir=ck, **shard_kw))
    head = sum(len(c[-1]) for c in itertools.islice(
        coexplore.plan_joint_walk(models).chunks(), KILL_AFTER))
    if part.points_evaluated != head:
        fail(f"scale: the killed walk evaluated {part.points_evaluated} "
             f"points, not its first {KILL_AFTER} chunks' {head}")
    same("resumed / uninterrupted", resumed, sharded, rows=True)
    try:
        coexplore.coexplore_front(models, checkpoint_dir=ck, shards=2)
    except ValueError as e:
        if "different sweep" not in str(e):
            raise
        print("scale: a checkpoint of another sweep is refused")
    else:
        fail("scale: a checkpoint with another signature was resumed")

    # 3. the wide sweep, sharded, the front streamed to CSV
    wl = workloads.vgg16("cifar10", device=dev)
    wide_kw = dict(max_points=WIDE_POINTS, chunk_size=WIDE_CHUNK)
    csv_path = tmp / "wide_front.csv"
    plain_wide = timed("WIDE 2^20 unsharded", lambda: dse.pareto_front_streaming(
        wl, WIDE_SPACE, **wide_kw)[0], points=lambda a: WIDE_POINTS)
    wide = timed("WIDE 2^20 sharded", lambda: dse.pareto_front_streaming(
        wl, WIDE_SPACE, shards=SCALE_SHARDS, csv_path=str(csv_path),
        **wide_kw)[0], points=lambda a: WIDE_POINTS)
    o1, o2 = np.argsort(plain_wide.indices), np.argsort(wide.indices)
    if not (np.array_equal(plain_wide.indices[o1], wide.indices[o2])
            and np.array_equal(plain_wide.objectives[o1],
                               wide.objectives[o2])):
        fail("scale: the sharded WIDE_SPACE front differs from the unsharded")
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    if [int(r["index"]) for r in rows] != wide.indices.tolist() or any(
            [float(r[m]) for m in ("perf_per_area", "neg_energy_j")]
            != wide.objectives[i].tolist() for i, r in enumerate(rows)):
        fail("scale: the CSV rows are not the sharded front")
    print(f"scale WIDE 2^20: sharded / unsharded bitwise equal, front "
          f"{len(wide)} points, CSV rows = front")

    # 4. budgeted search over 3 models x MAPPED_SPACE
    three = models[:S.N_MODELS]
    ref_front = ref["ref_space"]["front"]
    enum = timed("REF_SPACE enumeration", lambda: coexplore.coexplore_front(
        three, space=S.ref_space(DEFAULT_SPACE), seed=S.SEED))
    ok, ties, bad = S._archives_close(S.front_data(enum.archive), ref_front,
                                      check.RTOL)
    if bad:
        fail(f"scale: the REF_SPACE front differs from the reference: {bad}")
    print(f"scale REF_SPACE front: {len(enum.archive)} points, "
          f"{len(ties)} near ties against the reference")
    out["search"] = {}
    for name, make in S.DRIVERS.items():
        runs = []
        for shards in (None, SCALE_SHARDS):
            rec = S.Recorder(make(search))
            if shards is None:
                first = rec
            front = timed(f"search {name} shards={shards or 1}",
                          lambda: search.search_front(
                              three, space=MAPPED_SPACE, driver=rec,
                              max_evals=S.SEARCH_EVALS, seed=S.SEED,
                              shards=shards))
            runs.append((rec, front))
        (_, front), (_, front4) = runs
        rec = first
        if not (np.array_equal(front.archive.indices, front4.archive.indices)
                and np.array_equal(front.archive.objectives,
                                   front4.archive.objectives)):
            fail(f"scale: search {name}: shards 1 and 4 differ")
        # against the port's REF_SPACE front (held to the reference's
        # above): coverage's ">= in every objective" is exact, so a
        # searched point that is itself a REF_SPACE front point covers
        # it only against objectives of the same package
        got = dict(log=rec.log, front=S.front_data(front.archive),
                   points_evaluated=int(front.points_evaluated),
                   **S.quality(search.hypervolume, search.front_coverage,
                               front.archive.objectives,
                               enum.archive.objectives))
        want = ref["search"][name]
        problems, notes = S.compare_search(
            got, want, explain=lambda g, p, rec=rec: S.halving_ties(rec, g, p),
            order_matters=name == "evolve")
        for n in notes:
            print(f"  tolerated (search {name}): {n}")
        if problems:
            fail(f"scale: search {name} differs from the JAX reference: "
                 + "; ".join(problems))
        out["search"][name] = dict(
            front=len(front.archive), hv_ratio=got["hv_ratio"],
            coverage=got["coverage"], ref_hv_ratio=want["hv_ratio"],
            ref_coverage=want["coverage"], generations=len(rec.log),
            notes=notes)
        print(f"scale search {name}: front {len(front.archive)}, hv_ratio "
              f"{got['hv_ratio']:.6f} (reference {want['hv_ratio']:.6f}), "
              f"coverage {got['coverage']:.3f} (reference "
              f"{want['coverage']:.3f}), shards 1 / 4 bitwise equal, "
              f"{len(notes)} notes")

    # 5. the front server: the 12-query storm on one shared walk
    budgets = [None if b is None else Budget(**b)
               for b in S.DISTINCT_BUDGETS]
    srv = FrontServer(models)
    qs = []

    def storm():
        qs.extend(srv.submit(budgets[i]) for i in S.STORM)
        srv.run()
        return srv
    timed("front server storm (12 queries)", storm,
          points=lambda _: max(q.response.points_evaluated for q in qs))
    n_chunks = sum(1 for _ in srv._plan.chunks())
    if srv.chunk_evals != n_chunks or srv.chunk_evals != \
            ref["storm"]["chunk_evals"]:
        fail(f"scale: the storm took {srv.chunk_evals} chunk evaluations, "
             f"not one walk of {n_chunks}")
    for i, want in enumerate(ref["storm"]["responses"]):
        problems, notes = S.compare_storm(S.storm_data(qs[i].response), want,
                                          want["near_bound"])
        for n in notes:
            print(f"  tolerated (storm {want['budget']}): {n}")
        if problems:
            fail(f"scale: storm query {want['budget']} differs from the JAX "
                 f"reference: " + "; ".join(problems))
    print(f"scale storm: 12 queries in one walk of {srv.chunk_evals} chunks; "
          f"the 8 distinct fronts match the JAX reference")
    for i in S.SPOT_CHECK:
        alone = coexplore.coexplore_front(models, budget=budgets[S.STORM[i]],
                                          prune=False)
        resp = qs[i].response
        if not (np.array_equal(resp.archive.indices, alone.archive.indices)
                and np.array_equal(resp.archive.objectives,
                                   alone.archive.objectives)):
            fail(f"scale: storm query {i} differs from its standalone walk")
    print(f"scale storm: queries {S.SPOT_CHECK} bitwise equal to standalone "
          f"walks, row order included")
    evals = srv.chunk_evals
    again = srv.query(budgets[1])
    if srv.chunk_evals != evals or again.served_from != "cache:repeat":
        fail(f"scale: a repeat query took {srv.chunk_evals - evals} chunk "
             f"evaluations ({again.served_from})")
    cache_dir = str(tmp / "frontcache")
    srv.cache.save(cache_dir)
    fresh = FrontServer(models, cache=FrontCache())
    fresh.cache.load(cache_dir)
    restored = fresh.query(budgets[1])
    if fresh.chunk_evals != 0 or not np.array_equal(
            restored.archive.indices, qs[1].response.archive.indices):
        fail("scale: a restored cache did not answer with 0 chunk "
             "evaluations")
    print("scale storm: a repeat and a restored cache answer with 0 chunk "
          "evaluations")
    out["storm"] = dict(chunk_evals=srv.chunk_evals,
                        fronts=[len(qs[i].response.archive)
                                for i in range(len(budgets))])

    # 6. (phase 6's LightPE-1 bfloat16 run with telemetry on: after the
    # build, ``serve_with_telemetry``)
    return out


def serve_with_telemetry(torch, dev):
    """Phase 6's LightPE-1 4 x 12 run twice, telemetry off and on: tokens
    and logits bitwise equal, the kernels launched as on the main path
    and the engine's counts."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import family_module
    from repro_torch.obs import Tracer
    from repro_torch.serve import ServeEngine, check, quantize_params

    ref = json.loads(SERVE_REF.read_text())
    cfg = get(ref["config"])
    mod = family_module(cfg)
    params = convert.params_from_numpy(mod.numpy_params(cfg, ref["param_seed"]),
                                       dev)
    packed = quantize_params(params, "lightpe1", min_size=ref["min_size"])
    prompts = [np.array(p) for p in ref["prompts"]]

    def run(tr):
        eng = ServeEngine(cfg, mod, packed, ref["batch_slots"],
                          ref["max_len"], telemetry=tr)
        return check.record(eng, prompts, ref["max_new"],
                            lambda t: t.float().cpu().numpy())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = run(None)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    tr = Tracer(rss_interval_s=0)
    quant_matmul.launches = 0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    traced = run(tr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"quant_matmul": quant_matmul.launches,
              "flash_attention": flash_attention.launches}
    if counts != SERVE_LAUNCHES:
        fail(f"serving with telemetry: launches {counts}, expected "
             f"{SERVE_LAUNCHES}")
    if traced["tokens"] != plain["tokens"] or any(
            not np.array_equal(np.asarray(a), np.asarray(b))
            for a, b in zip(traced["logits"], plain["logits"])):
        fail("serving with telemetry: tokens or logits differ from the run "
             "with telemetry off")
    reg = tr.registry
    got = (reg.counters["serve.requests"].value,
           reg.counters["serve.tokens"].value)
    if got != (len(prompts), len(prompts) * ref["max_new"]):
        fail(f"serving with telemetry: serve.requests / serve.tokens {got}")
    spans = {k: reg.histograms[f"serve.{k}"].summary()
             for k in ("prefill", "decode")}
    print(f"serving with telemetry: tokens and logits bitwise equal to the "
          f"run without; launches {counts}; serve.requests {got[0]:.0f}, "
          f"serve.tokens {got[1]:.0f}; prefill p50 "
          f"{spans['prefill']['p50'] * 1e3:.3f} ms, decode p50 "
          f"{spans['decode']['p50'] * 1e3:.3f} ms; {wall:.3f} s traced, "
          f"{plain_wall:.3f} s without")
    return dict(launches=counts, requests=got[0], tokens=got[1],
                wall_s=wall, plain_wall_s=plain_wall, prefill=spans["prefill"],
                decode=spans["decode"])


def check_attention_backward(torch, dev):
    """Phase 10.1: the flash attention backward kernel against its plain
    version at the training shape (float32, the training path's type:
    float32 QAT weights give float32 q, k, v; and bfloat16) and at the
    reference file's shape, two calls bitwise equal; timed beside the
    plain version, SDPA's backward and its bound."""
    from repro_torch.kernels.flash_attention import (attention_backward,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa_bwd
    from repro_torch.train_check import (LM_BATCH, LM_SEQ,
                                         attention_grad_errors)
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    gen = torch.Generator(device=dev).manual_seed(10)
    hq, hkv, d = 9, 3, 64
    rows = {}
    for name, b, s, dtype in (("train_f32", TRAIN_BATCH, TRAIN_SEQ,
                               torch.float32),
                              ("train_bf16", TRAIN_BATCH, TRAIN_SEQ,
                               torch.bfloat16),
                              ("ref_f32", LM_BATCH, LM_SEQ, torch.float32)):
        q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
        do = torch.randn((b, s, hq, d), generator=gen, device=dev)
        st = torch.zeros(b, dtype=torch.int32, device=dev)
        got = attention_backward(q, k, v, st, do, round_p=True)
        again = attention_backward(q, k, v, st, do, round_p=True)
        torch.cuda.synchronize()
        want = ref_attention_gqa_bwd(q, k, v, st, do, True, 0.0, True)
        err = attention_grad_errors(got, want, do)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        if not err["ok"] or not same:
            fail(f"flash attention backward {name}: {err}, two calls "
                 f"bitwise equal: {same}")
        kernel_ms = time_ms(torch, lambda: attention_backward(
            q, k, v, st, do, round_p=True))
        plain_ms = time_ms(torch, lambda: ref_attention_gqa_bwd(
            q, k, v, st, do, True, 0.0, True))
        # the library's backward of the same function: SDPA's graph made
        # once, its backward called alone (layout (B, H, S, D))
        tq, tk, tv = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = sdpa(tq, tk, tv, is_causal=True, enable_gqa=True)
        tdo = do.transpose(1, 2).to(out.dtype)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (tq, tk, tv), tdo, retain_graph=True))
        fwd_bwd_ms = time_ms(torch, lambda: _fa_fwd_bwd(
            torch, flash_attention_gqa, q, k, v, st, do))
        # each input read once and each gradient written once; the
        # operations the gradient needs on these inputs: q.k and dO.v
        # again, then dV, dK and dQ: 5 products of 2 D flops over the
        # visible (query head, key) pairs.  bound_ms: those products as
        # the kept bf16 part products of a float32-accurate product on the
        # tensor cores (30 a pair and column in float32, 13 in bfloat16),
        # the least the card takes; bound_plain_ms: the 5 products at the
        # type's own peak (float32 on the CUDA cores)
        pairs = b * hq * s * (s + 1) // 2
        el = q.element_size()
        bf16 = dtype == torch.bfloat16
        nbytes = (2 * el * (q.numel() + k.numel() + v.numel())
                  + 4 * do.numel())
        flops = 5 * 2 * d * pairs
        bound, by = bound_ms(nbytes, bwd_part_products(bf16, False) * 2 * d
                             * pairs, H100_BF16_FLOPS)
        bound_plain, by_plain = bound_ms(
            nbytes, flops, H100_BF16_FLOPS if bf16 else H100_F32_FLOPS)
        # the design's issued work, not a bound: its part products (q.k and
        # dO.v three times each; 54 a pair and column in float32, 21 in
        # bfloat16) at the tensor cores' peak
        issued = bwd_part_products(bf16, True) * 2 * d * pairs
        rows[name] = dict(shape=[b, s, hq, hkv, d], dtype=str(dtype),
                          max_abs_err=err["max_abs_err"], ms=kernel_ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          fwd_bwd_ms=fwd_bwd_ms, bound_ms=bound,
                          bound_by=by, bound_share=bound / kernel_ms,
                          bound_plain_ms=bound_plain,
                          bound_plain_by=by_plain,
                          issued_ms=issued / H100_BF16_FLOPS * 1e3,
                          tflops=flops / kernel_ms / 1e9,
                          tc_tflops=issued / kernel_ms / 1e9)
        before = (f", the CUDA-core kernel before it "
                  f"{CUDA_CORE_BWD_MS[name]:.4f} ms (a constant: its own "
                  f"chip run)" if name in CUDA_CORE_BWD_MS else "")
        print(f"flash_attention backward {name} {rows[name]['shape']}: "
              f"max |err| {err['max_abs_err']:.3g} vs plain, two calls "
              f"bitwise equal; kernel {kernel_ms:.4f} ms (forward + "
              f"backward {fwd_bwd_ms:.4f} ms){before}, plain {plain_ms:.4f} "
              f"ms, SDPA backward {library_ms:.4f} ms; bound {bound:.4f} ms "
              f"({by}, the kept part products on the bf16 tensor cores; "
              f"{bound / kernel_ms:.1%} of it), bound of the plain products "
              f"{bound_plain:.4f} ms ({by_plain}, "
              f"{'bf16 tensor cores' if bf16 else 'float32 CUDA cores'}); "
              f"the issued part products take {rows[name]['issued_ms']:.4f} "
              f"ms at the tensor cores' peak; {rows[name]['tflops']:.2f} "
              f"TFLOP/s of the gradient, {rows[name]['tc_tflops']:.1f} "
              f"TFLOP/s of part products")
    return rows


def bwd_part_products(bf16: bool, issued: bool) -> int:
    """The bf16 part products with round_p for each visible (query head,
    key) pair and column: the gradient's 5 products (q.k, dout.v, dq, dk,
    dv), or with ``issued`` the backward kernel's 9 (q.k and dout.v three
    times each: rows passes 1 and 2, keys); each of operands with 3 parts
    (float32) or 1 (bf16, and P rounded to bf16 for a bfloat16 V), the
    kept pairs of ``ref.PAIRS``."""
    kept = kept_part_products
    xp, times = (1 if bf16 else 3), (3 if issued else 1)
    return (times * kept(xp, xp) + times * kept(3, xp) + 2 * kept(3, xp)
            + kept(1 if bf16 else 3, 3))


def _fa_fwd_bwd(torch, fa, q, k, v, st, do):
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa(*leaves, st, round_p=True)
    return torch.autograd.grad(out, leaves, do)


def run_training(torch, dev):
    """Phase 10: QAT training on the card (see the module docstring)."""
    import tempfile

    from repro_torch import train_check as tc
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get
    from repro_torch.core.accuracy import AccuracySurrogate
    from repro_torch.data import lm_pipeline
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import family_module
    from repro_torch.optim import adamw, tree_leaves, warmup_cosine
    from repro_torch.train import (fit, init_state, make_train_step,
                                   resume)
    from repro_torch.train import qat

    out = {}
    bwd = check_attention_backward(torch, dev)
    out["backward"] = bwd

    # 2. held to the JAX package: the reference file's runs and controls
    ref = json.loads(TRAIN_REF.read_text())
    cfg = get("smollm-135m")
    t0 = time.perf_counter()
    held = {}
    for pe in tc.LM_PE_TYPES:
        rows = tc.run_lm(cfg, pe, dev)
        held[f"lm/{pe}"] = dict(rows=rows, **tc.compare(
            rows, ref["lm"]["runs"][pe], TRAIN_LM_RTOL))
    with tc.detached_attention():
        rows = tc.run_lm(cfg, "fp32", dev)
    held["control/detached"] = dict(rows=rows, **tc.compare(
        rows, ref["lm"]["runs"]["fp32"], TRAIN_LM_RTOL))
    held["control/lightpe1_vs_fp32"] = tc.compare(
        held["lm/lightpe1"]["rows"], ref["lm"]["runs"]["fp32"],
        TRAIN_LM_RTOL)
    for pe in tc.CNN_PE_TYPES:
        rows = tc.run_cnn(pe, dev)
        held[f"cnn/{pe}"] = dict(rows=rows, **tc.compare(
            rows, ref["cnn"]["runs"][pe], TRAIN_CNN_RTOL))
    for key, r in held.items():
        print(f"training held to the reference, {key}: loss rel "
              f"{r['loss_rel']:.3g}, grad norm rel {r['gnorm_rel']:.3g} "
              f"({'within' if r['ok'] else 'outside'} the tolerance)")
    bad = [k for k, r in held.items() if r["ok"] == k.startswith("control/")]
    if bad:
        fail(f"training against tests/data/torch_train_ref.json: {bad} "
             f"(controls must fail, runs must pass)")
    out["held"] = {k: {f: v for f, v in r.items() if f != "rows"}
                   for k, r in held.items()}
    out["held_s"] = time.perf_counter() - t0

    # 3. the example's settings: full width under LightPE-1, the main path
    cfg = get("smollm-135m").replace(pe_type="lightpe1")
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(3e-4, 20, TRAIN_STEPS))
    state = init_state(cfg, mod, opt,
                       torch.Generator(device=dev).manual_seed(0), device=dev)
    step = make_train_step(cfg, mod, opt)
    pipe = lm_pipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, device=dev)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_mb = torch.cuda.memory_allocated() / 2 ** 20
    fake_quant.launches = 0
    flash_attention.launches = 0
    flash_attention.backward_launches = 0
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        state, m = step(state, next(pipe))
        losses.append(m["loss"].item())
        times.append(time.perf_counter() - t1)
    counts = dict(fake_quant=fake_quant.launches,
                  flash_attention=flash_attention.launches,
                  flash_attention_backward=flash_attention.backward_launches)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    want = dict(fake_quant=TRAIN_STEPS * TRAIN_FQ_PER_STEP,
                flash_attention=TRAIN_STEPS * TRAIN_FWD_PER_LAYER
                * cfg.n_layers,
                flash_attention_backward=TRAIN_STEPS * cfg.n_layers)
    if counts != want:
        fail(f"training launches {counts}, want {want}")
    if not all(map(lambda x: x == x and abs(x) < 1e4, losses)):
        fail(f"training loss not finite: {losses}")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not last < first - TRAIN_MIN_DROP:
        fail(f"training loss did not fall: {losses}")
    p50 = sorted(times[2:])[len(times[2:]) // 2]
    out["train"] = dict(
        config="smollm-135m", pe_type="lightpe1", batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=TRAIN_STEPS, losses=losses,
        step_ms=[t * 1e3 for t in times], step_p50_ms=p50 * 1e3,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / p50, peak_mb=peak_mb,
        allocated_before_mb=before_mb,
        launches=counts,
        launches_per_step={k: v / TRAIN_STEPS for k, v in counts.items()})
    print(f"training SmolLM-135M lightpe1 {TRAIN_BATCH}x{TRAIN_SEQ}: "
          f"{TRAIN_STEPS} steps, p50 step {p50 * 1e3:.1f} ms = "
          f"{TRAIN_BATCH * TRAIN_SEQ / p50:.0f} tokens/s, peak device "
          f"memory {peak_mb:.1f} MiB ({before_mb:.1f} before), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches a step "
          f"{out['train']['launches_per_step']}")
    del state, step, pipe, m
    gc.collect()

    # 4. exact resume on the card: 10 steps straight against 5, a
    # checkpoint, a restore and 5 more
    t0 = time.perf_counter()
    cfg = get("smollm-135m").replace(pe_type="lightpe1")
    opt = adamw(warmup_cosine(1e-3, 5, 100))
    step = make_train_step(cfg, mod, opt)

    def fresh():
        return init_state(cfg, mod, opt,
                          torch.Generator(device=dev).manual_seed(1),
                          device=dev)

    quiet = lambda _msg: None  # noqa: E731
    straight = fit(fresh(), step, lm_pipeline(cfg, RESUME_BATCH, TRAIN_SEQ,
                                              device=dev), 10, log_fn=quiet)
    with tempfile.TemporaryDirectory() as tmp:
        fit(fresh(), step, lm_pipeline(cfg, RESUME_BATCH, TRAIN_SEQ,
                                       device=dev), 5,
            ckpt_dir=tmp, ckpt_every=5, log_fn=quiet)
        pipe = lm_pipeline(cfg, RESUME_BATCH, TRAIN_SEQ, device=dev)
        resumed = resume(cfg, mod, opt, tmp, pipe, device=dev)
        if int(resumed.step) != 5 or pipe.state.step != 5 or \
                ckpt.all_steps(tmp) != [5]:
            fail("resume did not restore step 5 and the pipeline")
        resumed = fit(resumed, step, pipe, 10, log_fn=quiet)
    pairs = list(zip(tree_leaves(straight.params)
                     + tree_leaves(straight.opt_state),
                     tree_leaves(resumed.params)
                     + tree_leaves(resumed.opt_state)))
    differing = sum(int((a != b).sum()) for a, b in pairs)
    if differing:
        fail(f"exact resume: {differing} elements differ after 10 steps")
    out["resume"] = dict(batch=RESUME_BATCH, seq=TRAIN_SEQ, steps=10,
                         leaves=len(pairs), differing=0,
                         seconds=time.perf_counter() - t0)
    print(f"exact resume: 10 steps straight == 5 + checkpoint + restore + "
          f"5, bitwise ({len(pairs)} tensors) in "
          f"{time.perf_counter() - t0:.1f} s")
    del straight, resumed, pairs
    gc.collect()

    # 5. the Figs. 5-6 run: examples/torch_train_qat.py --mode cnn, cut
    # to FIGS56_STEPS steps and one trial, and the port's AccuracySurrogate
    # loads the table; first, one seed gives one run
    t0 = time.perf_counter()
    runs = [tree_leaves(qat.train_cnn("lightpe1", FIGS56_REPEAT_STEPS,
                                      device=dev)) for _ in range(2)]
    differing = sum(int((a != b).sum()) for a, b in zip(*runs))
    if differing:
        fail(f"Figs. 5-6: two LightPE-1 CNN runs of {FIGS56_REPEAT_STEPS} "
             f"steps from one seed differ in {differing} elements")
    print(f"Figs. 5-6: two LightPE-1 CNN runs of {FIGS56_REPEAT_STEPS} "
          f"steps from one seed are bitwise equal ({len(runs[0])} tensors, "
          f"{time.perf_counter() - t0:.1f} s)")
    del runs
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "torch_qat_pareto.json")
        table = qat.run_cnn(steps=FIGS56_STEPS, depth=8,
                            trials=FIGS56_TRIALS, out=path, device=dev)
        loaded = AccuracySurrogate().load_qat_results(path=path)
    if loaded != 4:
        fail(f"AccuracySurrogate loaded {loaded} entries of the table")
    top1 = {pe: r["top1_mean"] for pe, r in table.items()}
    story = (all(a > 0.5 for a in top1.values())
             and abs(top1["fp32"] - top1["lightpe1"]) <= 0.1
             and abs(top1["int16"] - top1["lightpe1"]) <= 0.1)
    if not story:
        fail(f"Figs. 5-6: top-1 {top1} breaks the paper's story (every "
             f"type > 0.5, LightPE-1 within 0.1 of FP32 and INT16)")
    out["figs56"] = dict(table=table, seconds=time.perf_counter() - t0)
    print(f"Figs. 5-6 (ResNet-8, {FIGS56_STEPS} steps, {FIGS56_TRIALS} "
          f"trial): top-1 {top1}, "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def check_window_kernel(torch, dev):
    """Phase 11.1: the flash_attention kernel with a sliding window, a
    soft-cap and head_dim 256 against its plain version on the card, at
    Gemma-3-1B's and Gemma-2-9B's shapes past their windows, decode and
    prefill, float32 and bfloat16 q on the engine's float32 cache; each
    timed beside the plain version, its bound and SDPA with an explicit
    boolean window mask (with the soft-cap: ``flex_softcap``, on the
    same float32 inputs as SDPA's)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention import plan as fa_plan
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []
    for row in WINDOW_SHAPES:
        name, b, sq, skv, hq, hkv, d, start, window, softcap, scale = row
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        st = torch.full((b,), start, dtype=torch.int32, device=dev)
        for q_name in ("float32", "bfloat16"):
            q = torch.randn((b, sq, hq, d), generator=gen,
                            device=dev).to(getattr(torch, q_name))

            def kernel():
                return flash_attention_gqa(q, k, v, st, round_p=True,
                                           scale=scale, window=window,
                                           softcap=softcap)

            def plain():
                return ref_attention_gqa(q, k, v, st, round_p=True,
                                         scale=scale, window=window,
                                         softcap=softcap)

            before = flash_attention.launches
            got = kernel()
            again = kernel()
            launches = flash_attention.launches - before
            want = plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if launches != 2 or not torch.equal(got, again) \
                    or not bool(torch.isfinite(got).all()) or err > FA_TOL:
                fail(f"flash_attention {name} q {q_name}: max_abs_err "
                     f"{err} (tolerance {FA_TOL}), {launches} launches for "
                     f"2 calls, bitwise repeat {torch.equal(got, again)}")
            del want, got, again
            ms = time_ms(torch, kernel)
            plain_ms = time_ms(torch, plain, reps=3, warmup=1)
            tq = q.float().transpose(1, 2).contiguous()
            tk, tv = (t.transpose(1, 2).contiguous() for t in (k, v))
            if not softcap:   # SDPA on the same function, the window a mask
                qpos = start + torch.arange(sq, device=dev)[:, None]
                kpos = torch.arange(skv, device=dev)[None, :]
                mask = (kpos <= qpos) & (kpos > qpos - window)
                library = "SDPA with the window mask"

                def lib_call():
                    return sdpa(tq, tk, tv, attn_mask=mask,
                                scale=scale or None, enable_gqa=True)
            else:
                library = "flex_attention (compiled; soft-cap, window)"
                flex = flex_softcap(torch, sq, skv, start, window, softcap)

                def lib_call():
                    return flex(tq, tk, tv, scale or d ** -0.5)
            t_lib = time.perf_counter()
            lib_out = lib_call().transpose(1, 2)
            lib_s = time.perf_counter() - t_lib
            lib_err = float((lib_out - ref_attention_gqa(
                q.float(), k, v, st, round_p=False, scale=scale,
                window=window, softcap=softcap)).abs().max())
            if lib_err > LIBRARY_TOL:
                fail(f"{library} at {name}: max |err| {lib_err} against the "
                     f"plain version, above {LIBRARY_TOL}: not the same "
                     f"function")
            library_ms = time_ms(torch, lib_call)
            del tq, tk, tv, lib_out
            bound, by, nbytes, half = attention_bound(
                b, hq, hkv, d, [(max(0, start + i - window + 1) if window
                                 else 0, min(skv, start + i + 1))
                                for i in range(sq)],
                q_name == "bfloat16")
            p = fa_plan(b, sq, skv, hq, hkv, d, q_name == "bfloat16", window)
            rows.append(dict(
                name=name, q_type=q_name, b=b, sq=sq, skv=skv, hq=hq,
                hkv=hkv, d=d, start=start, window=window, softcap=softcap,
                max_abs_err=err, launches=launches, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library=library,
                library_max_abs_err=lib_err, library_first_call_s=lib_s,
                bound_ms=bound, bound_by=by,
                bytes=nbytes, visible_pairs=half // (2 * b * hq * d),
                variant=p.variant,
                splits=p.splits))
            lib = (f"{library} {library_ms:.4f} ms (max |err| {lib_err:.3g} "
                   f"vs plain on float32 q; first call {lib_s:.1f} s)")
            print(f"flash_attention {name} q {q_name} ({p.variant}, "
                  f"{p.splits} splits): max_abs_err={err:.3g}, two calls "
                  f"bitwise equal; kernel {ms:.4f} ms"
                  f"{_replaced(f'{name}/{q_name}', ms)}, plain "
                  f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), {lib}")
    return rows


def serve_runs(torch, ref, engine_for, launch_counters, want_counts, tol,
               router=None, coupled=False, records=None):
    """Serve the reference's prompts for each of the reference's modes and
    hold each run to its reference record; the launches of each run
    counted from 0 and held to ``want_counts(mode)`` exactly.  ``router``
    (an MoE model's capacity for a token count): the routing is recorded
    and held too (``check.compare``'s ``router_tol``), the reference's
    experts pinned at its router near ties (``RoutePins``).  A run of
    which no step was compared fails.  ``records`` (a dict) keeps each
    mode's record."""
    from contextlib import nullcontext

    import numpy as np
    from repro_torch.models.moe import RoutePins, RouterLog
    from repro_torch.serve import check

    prompts = [np.array(p) for p in ref["prompts"]]
    out = {}
    for key, m in ref["modes"].items():
        eng = engine_for(m)
        for c in launch_counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pins = RoutePins(ref["router_tol"]) if router else None
        with RouterLog() as log, (pins or nullcontext()):
            rec = check.record(eng, prompts, ref["max_new"],
                               lambda t: t.float().cpu().numpy(),
                               router=log if router else None, pins=pins,
                               want=m["run4"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if records is not None:
            records[key] = rec
        counts = {c.__name__: c.launches for c in launch_counters}
        if counts != want_counts(m):
            fail(f"{ref['config']} {key}: launches {counts}, expected "
                 f"{want_counts(m)}")
        del eng
        cuts = None
        kw = dict(coupled=coupled(m) if callable(coupled) else coupled)
        if router:
            kw.update(router_tol=ref["router_tol"], capacity=router)
            cuts = check.route_cut(rec, m["run4"], **kw)[0]
        routing = route_summary(rec, m, ref, pins) if router else None
        problems, notes = check.compare(rec, m["run4"], tol[key], **kw)
        for note in notes:
            print(f"  tolerated ({ref['config']} {key}): {note}")
        if problems:
            fail(f"{ref['config']} {key} differs from the JAX reference: "
                 + "; ".join(problems))
        err = check.max_logit_err(rec, m["run4"], kw["coupled"], cuts)
        steps = check.compared_steps(rec, m["run4"], kw["coupled"], cuts)
        if not sum(steps):
            fail(f"{ref['config']} {key}: no step was compared with the JAX "
                 f"reference ({len(notes)} notes)")
        out[key] = dict(launches=counts, wall_s=wall, max_logit_err=err,
                        tolerance=tol[key], steps_compared=steps,
                        notes=len(notes), tokens0=rec["tokens"][0])
        print(f"{ref['config']} {key}: matches the JAX reference (max logit "
              f"err {err:.3g}, tolerance {tol[key]}, steps compared {steps} "
              f"of {ref['max_new']}, {len(notes)} notes); launches {counts}; "
              f"{wall:.3f} s; tokens of request 0: {rec['tokens'][0]}")
        if router:
            out[key]["routing"] = routing
    return out


def route_summary(rec, mode, ref, pins):
    """The port's run's router margins below the reference file's
    tolerance and its steps' drops past capacity, beside the reference's
    counts (the same routing gives the same drops); the tokens that took
    the reference's experts at a near tie (``pins``); and the router's
    noise: the largest difference of a margin from the reference's at the
    prefill's first MoE layer, over the tokens routed alike there on
    their own (only the dense layer before it, so no routing difference
    feeds it)."""
    import numpy as np
    from repro_torch.configs import get
    from repro_torch.models.moe import dropped
    cfg = get(ref["config"]).replace(n_layers=ref["n_layers"])
    margins = np.array([x for req in rec["route_margins"] for step in req
                        for layer in step for x in layer])
    drops = [[dropped(np.array([req[t][layer] for req in rec["routes"]]),
                      cfg) for layer in range(len(rec["routes"][0][t]))]
             for t in range(len(rec["routes"][0]))]
    want = mode["run4"]
    ids = np.array([req[0][0] for req in rec["routes"]])
    ids_ref = np.array([req[0][0] for req in want["routes"]])
    first = pins.masks[0]                     # the prefill's first MoE layer
    alike = np.all(ids == ids_ref, axis=-1) & ~first
    delta = np.abs(np.array([req[0][0] for req in rec["route_margins"]])
                   - np.array([req[0][0] for req in want["route_margins"]]))
    summary = dict(near_ties=int((margins < ref["router_tol"]).sum()),
                   margins=int(margins.size), dropped_prefill=drops[0],
                   ref_near_ties=mode["routing"]["near_ties"],
                   ref_dropped_prefill=mode["routing"]["dropped"][0],
                   first_layer_tokens_alike=int(alike.sum()),
                   first_layer_tokens=int(alike.size),
                   first_layer_pinned=int(first.sum()), pinned=pins.pinned,
                   margin_noise=float(delta[alike].max()))
    print(f"  routing: {summary['near_ties']} of {margins.size} router "
          f"margins below {ref['router_tol']} (reference "
          f"{summary['ref_near_ties']}); prefill drops past capacity "
          f"{drops[0]} (reference {summary['ref_dropped_prefill']}); first "
          f"MoE layer: {alike.sum()} of {alike.size} prefill tokens routed "
          f"alike on their own ({first.sum()} pinned), their margins within "
          f"{summary['margin_noise']:.3g} of the reference's; "
          f"{pins.pinned} tokens of all steps and layers took the "
          f"reference's experts at a near tie")
    return summary


def run_gemma(torch, dev):
    """Phase 11.2: Gemma-3-1B at full width and depth, packed as
    LightPE-1 and INT8 codes and served by ``ServeEngine`` (4 prompts of
    64-900 tokens, a 1024-row cache, 12 new tokens) in bfloat16 and
    float32, held to ``tests/data/torch_gemma3_ref.json`` with exactly 182
    ``quant_matmul`` and 26 ``flash_attention`` launches a step; then the
    LightPE-1 bfloat16 run warm: step latencies, tokens/s, peak memory.
    Returns (numbers, the packed params by PE type, codes pinned, and each
    mode's record), which phase 12 serves again."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import family_module
    from repro_torch.serve import (ServeEngine, check, packed_bytes,
                                   quantize_params)

    ref = json.loads(GEMMA_REF.read_text())
    cfg = get(ref["config"])
    mod = family_module(cfg)
    t0 = time.perf_counter()
    params = convert.params_from_numpy(
        numpy_draw(mod, cfg, ref["param_seed"]), dev)
    packs = {pe: quantize_params(params, pe, min_size=ref["min_size"])
             for pe in sorted({m["pe_type"] for m in ref["modes"].values()})}
    del params
    gc.collect()
    torch.cuda.synchronize()
    print(f"gemma: {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads "
          f"of {cfg.head_dim}, window {cfg.window}, vocab {cfg.vocab}); "
          f"weights drawn and packed in {time.perf_counter() - t0:.2f} s")
    for key, m in ref["modes"].items():
        got = packed_bytes(packs[m["pe_type"]])
        if got != m["packed_bytes"]:
            fail(f"gemma {key}: packed_bytes {got} != the JAX package's "
                 f"{m['packed_bytes']}")
    # the reference's LightPE-1 codes where log2|w| is at a tie: the served
    # comparison then runs on the JAX package's codes
    pins = check.pin_pow2_codes(packs["lightpe1"], ref["pow2_ties"])
    if pins["e_max_differ"]:
        fail(f"gemma: {pins['e_max_differ']} columns' e_max differ from the "
             f"reference's at an absmax log2 tie")
    print(f"gemma: the reference's LightPE-1 codes at {pins['pinned']} log2 "
          f"ties pinned, {pins['changed']} of them the card's other code; "
          f"{pins['e_max_ties']} columns' e_max at a tie, all equal")
    per_step = {"quant_matmul": GEMMA_PROJECTIONS * cfg.n_layers,
                "flash_attention": cfg.n_layers}
    records = {}
    runs = serve_runs(
        torch, ref,
        lambda m: ServeEngine(cfg.replace(dtype=m["dtype"]), mod,
                              packs[m["pe_type"]], ref["batch_slots"],
                              ref["max_len"]),
        (quant_matmul, flash_attention),
        lambda m: {k: v * ref["max_new"] for k, v in per_step.items()},
        GEMMA_TOL, records=records)

    eng = ServeEngine(cfg, mod, packs["lightpe1"], ref["batch_slots"],
                      ref["max_len"])
    steps = {"prefill": [], "decode": []}

    def timed(name, fn):
        def step(p, t, c):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(p, t, c)
            torch.cuda.synchronize()
            steps[name].append(time.perf_counter() - t1)
            return out
        return step

    eng._prefill = timed("prefill", eng._prefill)
    eng._decode = timed("decode", eng._decode)
    gc.collect()
    base = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    reqs = [eng.submit(np.array(p), max_new=ref["max_new"])
            for p in ref["prompts"]]
    eng.run()
    wall = time.perf_counter() - t1
    tokens = sum(len(r.out) for r in reqs)
    numbers = dict(prefill_ms=steps["prefill"][0] * 1e3,
                   decode_ms=float(np.mean(steps["decode"])) * 1e3,
                   tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
                   peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
                   base_mib=base, runs=runs)
    numbers["pow2_pins"] = pins
    print(f"gemma lightpe1 (warm): prefill {numbers['prefill_ms']:.3f} ms "
          f"(4 x {max(len(p) for p in ref['prompts'])} tokens), decode "
          f"{numbers['decode_ms']:.3f} ms/step, {tokens} tokens in "
          f"{wall:.3f} s = {numbers['tokens_per_s']:.1f} tokens/s, peak "
          f"device memory {numbers['peak_mib']:.1f} MiB ({base:.1f} MiB "
          f"before the run)")
    del eng
    gc.collect()
    return numbers, packs, records


def check_expert_fake_quant(torch, dev, cfg, mod, params, ref):
    """Phase 11.3's kernel check: ``fake_quant_experts`` and
    ``fake_quant_expert_acts`` on the card on what the first MoE layer
    gives them under each QAT mode of the reference (caught in a prefill
    of the reference's prompts and one decode step): the expert stacks
    (64 x (2048, 1408) and 64 x (1408, 2048), float32) and the dispatched
    buffers (64, C, 2048) and (64, C, 1408) in the compute type.  Each
    call is one ``fake_quant`` launch and differs in no element from the
    plain version run expert by expert on the same input; the stack
    quantized as one tensor (one scale over every expert) must differ
    from it, so the check tells the two apart."""
    import numpy as np
    from repro_torch.kernels.fake_quant import fake_quant, fake_quant_group
    from repro_torch.kernels.fake_quant.ref import (ref_fake_quant_affine,
                                                    ref_fake_quant_pow2)
    from repro_torch.models import moe as MOE
    from repro_torch.quant.fake_quant import (affine_scale,
                                              fake_quant_expert_acts,
                                              fake_quant_experts, pow2_emax)

    def scales_of(x, scheme, bits, per_channel):
        """Each expert's own scale (e_max for pow2), as the port takes it."""
        axis = 0 if per_channel else None
        out = []
        for xe in x.unbind(0):
            sc = (affine_scale(xe, bits, axis) if scheme == "affine"
                  else pow2_emax(xe, axis))
            out.append(sc[0] if per_channel else sc.reshape(1))
        return out

    def plain(x, scales, scheme, bits):
        return torch.stack([
            ref_fake_quant_affine(xe, sc, bits) if scheme == "affine"
            else ref_fake_quant_pow2(xe, sc)
            for xe, sc in zip(x.unbind(0), scales)])

    lens = [len(pr) for pr in ref["prompts"]]
    toks = np.zeros((len(lens), max(lens)), np.int64)
    for i, pr in enumerate(ref["prompts"]):
        toks[i, -len(pr):] = pr
    toks = torch.as_tensor(toks, device=dev)
    calls = []

    def catch(fn, kind):
        def caught(x, qcfg):
            calls.append((kind, x.detach(), qcfg))
            return fn(x, qcfg)
        return caught

    rows = []
    for key, m in ref["modes"].items():
        if m["pe_type"] == "fp32":
            continue
        run = cfg.replace(pe_type=m["pe_type"], dtype=m["dtype"])
        cache = mod.init_cache(run, len(lens), ref["max_len"], torch.float32,
                               device=dev)
        caught = {}
        MOE.fake_quant_experts = catch(fake_quant_experts, "weight")
        MOE.fake_quant_expert_acts = catch(fake_quant_expert_acts, "act")
        try:
            for phase in ("prefill", "decode"):
                calls.clear()
                if phase == "prefill":
                    logits, cache = mod.prefill(params, toks, run, cache)
                else:
                    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
                    logits, cache = mod.decode_step(params, nxt, run, cache)
                # the first MoE layer's 3 weights and 3 buffers
                caught[phase] = ([c for c in calls if c[0] == "weight"][:3]
                                 + [c for c in calls if c[0] == "act"][:3])
        finally:
            MOE.fake_quant_experts = fake_quant_experts
            MOE.fake_quant_expert_acts = fake_quant_expert_acts
        del cache, logits
        for phase, held in caught.items():
            for kind, x, qcfg in held:
                if kind == "weight" and phase == "decode":
                    continue              # the prefill's stacks again
                fn = (fake_quant_experts if kind == "weight"
                      else fake_quant_expert_acts)
                scheme, bits, per_channel = (
                    (qcfg.weight_scheme, qcfg.weight_bits, qcfg.per_channel)
                    if kind == "weight" else ("affine", qcfg.act_bits, False))
                before = fake_quant.launches
                got = fn(x, qcfg)
                launches = fake_quant.launches - before
                scales = scales_of(x, scheme, bits, per_channel)
                want = plain(x, scales, scheme, bits)
                stack = x.reshape(1, -1, x.shape[-1])
                one = plain(stack, scales_of(stack, scheme, bits,
                                             per_channel),
                            scheme, bits).reshape(x.shape)
                differing = int((got != want).sum())
                control = int((one != want).sum())
                if launches != 1 or differing or not control:
                    fail(f"fake_quant {key} expert {kind}s at "
                         f"{tuple(x.shape)} ({phase}): {launches} launches "
                         f"(1 expected), {differing} elements differ from "
                         f"plain, the stack as one tensor differs in "
                         f"{control}")
                # the launch and its plain version on the same scales
                parts = list(x.unbind(0))
                ms = time_ms(torch, lambda: fake_quant_group(
                    parts, scales, mode=scheme, bits=bits))
                plain_ms = time_ms(torch, lambda: plain(x, scales, scheme,
                                                        bits))
                # x read once, the output written once; a few operations
                # an element (scale, round, clamp, rescale)
                bound, by = bound_ms(2 * x.numel() * x.element_size(),
                                     4 * x.numel())
                rows.append(dict(mode=key, kind=kind, phase=phase,
                                 shape=list(x.shape), dtype=str(x.dtype),
                                 launches=launches, differing=differing,
                                 elements=x.numel(), as_one_differing=control,
                                 ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=by))
                print(f"fake_quant {key} expert {kind}s {tuple(x.shape)} "
                      f"{str(x.dtype).split('.')[-1]} ({phase}): 1 launch, "
                      f"0 of {x.numel()} elements differ from plain (the "
                      f"stack as one tensor: {control}); kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
                del got, want, one
        del caught
    return rows


def run_moe(torch, dev):
    """Phase 11.3: DeepSeek-MoE-16B at full width, depth cut to 3 layers
    (the dense layer and 2 MoE layers), on dense float32 weights, served
    by ``ServeEngine`` (4 prompts of 8-130 tokens, 12 new tokens) in
    bfloat16 under the FP32 preset and the QAT numerics of LightPE-1 and
    INT8, held to ``tests/data/torch_moe_ref.json``, routing included up
    to router near ties (the reference's experts pinned there); exactly 3
    ``flash_attention`` launches a step and 56 ``fake_quant`` ones under
    QAT numerics.  First ``check_expert_fake_quant`` holds the experts'
    grouped ``fake_quant`` launches to their plain version at these
    shapes.  Returns (numbers, the params copied to the host), which
    phase 14.4 serves again: the card holds none of them through phases
    12 and 13, whose peaks stay those of the phases alone."""
    from repro_torch import convert
    from repro_torch.configs import get
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import family_module
    from repro_torch.models.moe import capacity
    from repro_torch.serve import ServeEngine

    ref = json.loads(MOE_REF.read_text())
    cfg = get(ref["config"]).replace(n_layers=ref["n_layers"])
    mod = family_module(cfg)
    t0 = time.perf_counter()
    params = convert.params_from_numpy(
        numpy_draw(mod, cfg, ref["param_seed"]), dev)
    torch.cuda.synchronize()
    print(f"moe: {cfg.name} at full width ({cfg.n_layers} layers: "
          f"{cfg.first_dense} dense + {cfg.n_layers - cfg.first_dense} MoE of "
          f"{cfg.moe_experts} experts, top-{cfg.moe_topk}, {cfg.moe_shared} "
          f"shared; d_model {cfg.d_model}); dense weights "
          f"{ref['dense_bytes']} B drawn in {time.perf_counter() - t0:.2f} s")
    # fake_quant a step: 2 a projection (weight, activation) of the dense
    # layer (7), of each MoE layer's attention (4), routed experts (3, each
    # one launch for all 64 experts) and shared experts (3), and the head
    moe_layers = cfg.n_layers - cfg.first_dense
    fq = 2 * (7 * cfg.first_dense + 10 * moe_layers + 1)

    def want(m):
        return {"fake_quant": 0 if m["pe_type"] == "fp32"
                else fq * ref["max_new"],
                "flash_attention": cfg.n_layers * ref["max_new"],
                "quant_matmul": 0}

    experts = check_expert_fake_quant(torch, dev, cfg, mod, params, ref)
    gc.collect()
    runs = serve_runs(
        torch, ref,
        lambda m: ServeEngine(cfg.replace(pe_type=m["pe_type"],
                                          dtype=m["dtype"]), mod, params,
                              ref["batch_slots"], ref["max_len"]),
        (fake_quant, flash_attention, quant_matmul), want, MOE_TOL,
        router=lambda tokens: capacity(tokens, cfg),
        coupled=lambda m: m["pe_type"] != "fp32")
    from repro_torch.optim import tree_map
    host = tree_map(lambda t: t.cpu(), params)
    del params
    gc.collect()
    return dict(runs=runs, expert_fake_quant=experts), host


def _counts(*counters):
    return {c.__name__: c.launches for c in counters}


def _zero(torch, *counters):
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0


def _held(name, res):
    if not res["ok"]:
        fail(f"{name} differs from its reference: {res}")
    print(f"{name}: matches (max abs err {res['max_abs_err']:.4g}, "
          f"{res['ties']} of {res['positions']} positions chose another "
          f"token at a near tie)")


@contextlib.contextmanager
def plain_kernels(torch):
    """The model modules' kernel calls (``flash_attention_gqa``,
    ``quant_matmul``, the block-local layers' one launch, and the
    ``fake_quant`` groups of the QAT numerics) replaced by the kernels'
    plain versions on the card's tensors: block-local attention by the
    reference's blocked computation, each fake-quantized tensor by
    ``ref_fake_quant_affine`` / ``ref_fake_quant_pow2``.  The reference of
    a full-depth run, which the JAX package cannot make (no full-size
    configuration runs on the CPU that writes the reference files)."""
    from repro_torch.kernels.fake_quant import fake_quant as fq_kernel
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    from repro_torch.kernels.quant_matmul.ref import ref_quant_matmul
    from repro_torch.models import block_attn, flash_attn, layers, transformer
    from repro_torch.quant import fake_quant as quant_fq

    fq_module = sys.modules[fq_kernel.__module__]

    def attention(q, k, v, q_start=None, *, causal=True, scale=0.0,
                  round_p=False, window=0, softcap=0.0):
        if q_start is None:
            q_start = torch.zeros(q.shape[0], dtype=torch.int32,
                                  device=q.device)
        return ref_attention_gqa(q, k, v, q_start, causal, scale, round_p,
                                 window, softcap)

    def qmm(x, w, scale, *, mode="int4", cast=None):
        return ref_quant_matmul(x, w, scale, mode, cast)

    def fq_group(ws, scales, *, mode="affine", bits=8):
        return [fq_module._plain(w, sc, mode, bits)
                for w, sc in zip(ws, scales)]

    def block_local(q, k, v, positions, window, softcap, query_scale,
                    checked=False):
        scale = query_scale or 1.0 / math.sqrt(q.shape[-1])
        return block_attn._plain(q, k, v, positions, window, softcap, scale)

    swaps = [(layers, "flash_attention_gqa", attention),
             (layers, "quant_matmul", qmm),
             (transformer, "flash_attention_gqa", attention),
             (transformer, "block_local_attention", block_local),
             (block_attn, "flash_attention_gqa", attention),
             (flash_attn, "flash_attention_gqa", attention),
             (quant_fq, "fake_quant_group", fq_group)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_block_local(torch, dev, packs, ref):
    """Phase 12.1: Gemma-3-1B under ``attn_block_local``, ``forward`` on 2
    x 1024 tokens, LightPE-1 codes, bfloat16: at the reference's cut depth
    (8 layers) held to the JAX package's block-local forward, and at full
    width and depth (phase 11.2's packing) held to the same forward on the
    kernels' plain versions (``plain_kernels``: the local layers through
    the reference's blocked computation); exactly one ``flash_attention``
    launch and 7 ``quant_matmul`` ones a layer.  The baseline forward is
    timed beside it."""
    from repro_torch import convert, variants_check as vc
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import transformer as T
    from repro_torch.serve import check, quantize_params

    part = ref["gemma_block_local"]
    full = get(vc.GEMMA_CONFIG)
    cut = full.replace(n_layers=part["n_layers"])
    packed = quantize_params(convert.params_from_numpy(
        T.numpy_params(cut, vc.PARAM_SEED), dev), "lightpe1",
        min_size=part["min_size"])
    pins = check.pin_pow2_codes(packed, part["pow2_ties"])
    if pins["e_max_differ"]:
        fail(f"block-local: {pins['e_max_differ']} columns' e_max differ")
    out = dict(pow2_pins=pins)
    for name, cfg, params in (("cut", cut, packed),
                              ("full", full, packs["lightpe1"])):
        _zero(torch, flash_attention, quant_matmul)
        t0 = time.perf_counter()
        got = vc.gemma_forward(cfg, params, part["shape"], dev)
        wall = time.perf_counter() - t0
        counts = _counts(flash_attention, quant_matmul)
        want = {"flash_attention": cfg.n_layers,
                "quant_matmul": GEMMA_PROJECTIONS * cfg.n_layers}
        if counts != want:
            fail(f"block-local gemma ({name}): launches {counts}, expected "
                 f"{want}")
        if name == "cut":
            res = vc.compare_forward(got, part["run"], GEMMA_TOL["lightpe1"])
            _held(f"gemma3-1b block-local forward ({cfg.n_layers} layers) "
                  f"/ JAX", res)
        else:
            with plain_kernels(torch):
                plain = vc.gemma_forward(cfg, params, part["shape"], dev)
            if _counts(flash_attention, quant_matmul) != counts:
                fail("block-local gemma (full): the plain run launched a "
                     "kernel")
            res = vc.compare_forward(got, plain, GEMMA_TOL["lightpe1"])
            _held(f"gemma3-1b block-local forward ({cfg.n_layers} layers) "
                  f"/ its plain versions (blocked local layers)", res)
            toks = torch.as_tensor(vc.tokens(cfg.vocab, part["shape"]),
                                   device=dev)
            for mode in (True, False):
                run = cfg.replace(attn_block_local=mode)
                with torch.no_grad():
                    ms = time_ms(torch, lambda: T.forward(params, toks, run),
                                 reps=3, warmup=1, queued=False)
                out["forward_ms" if mode else "baseline_forward_ms"] = ms
        out[name] = dict(launches=counts, wall_s=wall, **res)
    print(f"gemma3-1b forward 2 x 1024 (26 layers, host-paced): block-local "
          f"{out['forward_ms']:.3f} ms, baseline {out['baseline_forward_ms']:.3f}"
          f" ms")
    del packed
    gc.collect()
    return out


def run_kv_replicated(torch, dev, packs, gemma_records):
    """Phase 12.2: Gemma-3-1B served with ``kv_replicate_to=4`` (the
    cache (4, 1024, 4, 256)) on phase 11.2's requests and packings, held
    to ``tests/data/torch_gemma3_ref.json`` (replicated heads compute the
    same function) and to phase 11.2's records (tokens equal up to a near
    tie, logits within 11.2's tolerances), with 11.2's launch counts."""
    from repro_torch.serve import check
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import family_module
    from repro_torch.serve import ServeEngine

    ref = json.loads(GEMMA_REF.read_text())
    cfg = get(ref["config"]).replace(kv_replicate_to=KV_REPLICATE_TO)
    mod = family_module(cfg)
    shapes = []

    def engine(m):
        eng = ServeEngine(cfg.replace(dtype=m["dtype"]), mod,
                          packs[m["pe_type"]], ref["batch_slots"],
                          ref["max_len"])
        shapes.append(tuple(eng.cache["scan"]["k"].shape[1:]))
        return eng

    per_step = {"quant_matmul": GEMMA_PROJECTIONS * cfg.n_layers,
                "flash_attention": cfg.n_layers}
    records = {}
    runs = serve_runs(torch, ref, engine, (quant_matmul, flash_attention),
                      lambda m: {k: v * ref["max_new"]
                                 for k, v in per_step.items()}, GEMMA_TOL,
                      records=records)
    want_shape = (ref["batch_slots"], ref["max_len"], KV_REPLICATE_TO,
                  cfg.head_dim)
    if any(s != want_shape for s in shapes):
        fail(f"kv_replicate_to={KV_REPLICATE_TO}: caches {shapes}, expected "
             f"{want_shape}")
    for key, rec in records.items():
        problems, notes = check.compare(rec, gemma_records[key],
                                        GEMMA_TOL[key])
        if problems:
            fail(f"kv_replicate_to={KV_REPLICATE_TO} {key} differs from "
                 f"phase 11.2's run: " + "; ".join(problems))
        same = rec["tokens"] == gemma_records[key]["tokens"]
        runs[key]["vs_phase_11_2"] = dict(
            tokens_equal=same, notes=len(notes),
            max_logit_err=check.max_logit_err(rec, gemma_records[key]))
        print(f"gemma3-1b kv_replicate_to={KV_REPLICATE_TO} {key} / phase "
              f"11.2: tokens equal {same}, max logit err "
              f"{runs[key]['vs_phase_11_2']['max_logit_err']:.3g}, "
              f"{len(notes)} notes")
    print(f"gemma3-1b kv_replicate_to={KV_REPLICATE_TO}: caches {want_shape}")
    return dict(runs=runs, cache_shape=list(want_shape))


def run_flash_variant(torch, dev, ref):
    """Phase 12.3 / 12.4: SmolLM-135M under ``attn_flash``, ``forward`` at
    4 x 2048 in float32 and bfloat16 held to the JAX package's (one
    ``flash_attention`` launch a layer), and ``train_check``'s AdamW steps
    at 4 x 128 under ``attn_flash`` (FP32, LightPE-1) and under
    ``compute_dtype(bfloat16)`` (LightPE-1) held to the JAX package's,
    with two forward launches a layer a step (the layer's recomputation)
    and a backward launch and, under LightPE-1, 842 ``fake_quant``
    launches a step."""
    from repro_torch import convert, train_check as tc, variants_check as vc
    from repro_torch.configs import get
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as T

    part = ref["smollm_flash"]
    cfg = get(vc.FLASH_CONFIG)
    params = convert.params_from_numpy(T.numpy_params(cfg, vc.PARAM_SEED),
                                       dev)
    out = {"forward": {}, "train": {}}
    for dtype in vc.FLASH_DTYPES:
        _zero(torch, flash_attention)
        got = vc.flash_forward(cfg, params, part["shape"], dtype, dev)
        if flash_attention.launches != cfg.n_layers:
            fail(f"attn_flash forward {dtype}: {flash_attention.launches} "
                 f"flash_attention launches, expected {cfg.n_layers}")
        res = vc.compare_forward(got, part["runs"][dtype], FLASH_TOL[dtype])
        _held(f"smollm-135m attn_flash forward 4 x 2048 {dtype} / JAX", res)
        out["forward"][dtype] = dict(launches=cfg.n_layers, **res)
    del params
    gc.collect()
    runs = [("flash", pe, cfg.replace(attn_flash=True), None)
            for pe in vc.FLASH_TRAIN_PE_TYPES]
    runs.append(("mixed", vc.MIXED_PE_TYPE, cfg, torch.bfloat16))
    for kind, pe, run_cfg, ct in runs:
        flash_attention.backward_launches = 0
        _zero(torch, flash_attention, fake_quant)
        rows = tc.run_lm(run_cfg, pe, dev, compute_dtype=ct)
        torch.cuda.synchronize()
        counts = dict(forward=flash_attention.launches,
                      backward=flash_attention.backward_launches,
                      fake_quant=fake_quant.launches)
        want = dict(forward=TRAIN_FWD_PER_LAYER * cfg.n_layers
                    * tc.LM_STEPS,
                    backward=cfg.n_layers * tc.LM_STEPS,
                    fake_quant=0 if pe == "fp32"
                    else TRAIN_FQ_PER_STEP * tc.LM_STEPS)
        if counts != want:
            fail(f"{kind} {pe} training: launches {counts}, expected {want}")
        res = tc.compare(rows, ref["smollm_train"][kind][pe], TRAIN_LM_RTOL)
        if not res["ok"]:
            fail(f"{kind} {pe} training differs from the JAX steps: {res}; "
                 f"{rows} vs {ref['smollm_train'][kind][pe]}")
        print(f"smollm-135m {kind} {pe} {tc.LM_STEPS} AdamW steps: match "
              f"(loss rel {res['loss_rel']:.3g}, grad norm rel "
              f"{res['gnorm_rel']:.3g}); launches {counts}")
        out["train"][f"{kind}/{pe}"] = dict(launches=counts, rows=rows, **res)
    out["mixed_control"] = mixed_control(torch, dev, cfg, ref, out["train"])
    return out


def mixed_control(torch, dev, cfg, ref, train):
    """Phase 12.4's control: the card's steps are bitwise repeatable, so
    the mixed run made again must give the same rows, and the same steps
    without ``compute_dtype`` other rows (a port that ignored the context
    would give the same).  Beside it, the readings that show why loss and
    gradient norm cannot tell the two apart against the JAX package at
    this depth: the run without the cast against JAX's mixed rows, and
    JAX's own mixed rows against its float32 ones."""
    from repro_torch import train_check as tc, variants_check as vc

    pe = vc.MIXED_PE_TYPE
    mixed = train[f"mixed/{pe}"]["rows"]
    again = tc.run_lm(cfg, pe, dev, compute_dtype=torch.bfloat16)
    plain = tc.run_lm(cfg, pe, dev)
    if again != mixed:
        fail(f"mixed {pe} training is not repeatable: {again} vs {mixed}")
    if plain == mixed:
        fail(f"{pe} training without compute_dtype gives the mixed run's "
             f"rows: the cast did not happen")
    jax_rows = ref["smollm_train"]
    res = dict(
        uncast_vs_mixed=tc.compare(plain, mixed, 0.0),
        uncast_vs_jax_mixed=tc.compare(plain, jax_rows["mixed"][pe],
                                       TRAIN_LM_RTOL),
        jax_mixed_vs_jax_float32=tc.compare(jax_rows["mixed"][pe],
                                            jax_rows["flash"][pe],
                                            TRAIN_LM_RTOL),
        uncast_rows=plain)
    for key in ("uncast_vs_mixed", "uncast_vs_jax_mixed",
                "jax_mixed_vs_jax_float32"):
        r = res[key]
        print(f"mixed-precision control {key}: loss rel {r['loss_rel']:.3g}, "
              f"grad norm rel {r['gnorm_rel']:.3g}")
    print("mixed-precision control: the mixed run repeats bitwise and the "
          "run without the cast differs from it")
    return res


def run_whisper(torch, dev, ref):
    """Phase 12.5: Whisper-medium on seed-0 weights, the frontend stub's
    frames (4 x 1500), prompts of 8, 12 greedy tokens, a 448-row cache
    (``serve.check.record_encdec``): at the reference's cut depth (4 + 4
    layers), on dense weights (FP32) and on LightPE-1 and INT8 packed
    codes, held to the JAX package's runs; at full width and depth (24 +
    24) on LightPE-1 codes, 384 ``quant_matmul`` and 72
    ``flash_attention`` launches a prefill and 240 and 48 a decode step,
    timed, and the greedy run held to the same run on the kernels' plain
    versions (``plain_kernels``)."""
    import numpy as np
    from repro_torch import convert, variants_check as vc
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import encdec
    from repro_torch.serve import check, quantize_params

    part = ref["whisper"]
    full = get(vc.WHISPER_CONFIG)
    cut = full.replace(enc_layers=part["enc_layers"],
                       dec_layers=part["dec_layers"])
    dense = convert.params_from_numpy(encdec.numpy_params(cut, vc.PARAM_SEED),
                                      dev)
    packs = {pe: quantize_params(dense, pe, min_size=part["min_size"])
             for pe in ("lightpe1", "int8")}
    pins = check.pin_pow2_codes(packs["lightpe1"], part["pow2_ties"])
    if pins["e_max_differ"]:
        fail(f"whisper: {pins['e_max_differ']} columns' e_max differ")
    out = dict(pow2_pins=pins, runs={})

    def per_run(cfg, packed):
        steps = part["max_new"] - 1
        qmm = (6 * cfg.enc_layers + 10 * cfg.dec_layers) if packed else 0
        dec_qmm = 10 * cfg.dec_layers if packed else 0
        return {"quant_matmul": qmm + steps * dec_qmm,
                "flash_attention": cfg.enc_layers + 2 * cfg.dec_layers
                + steps * 2 * cfg.dec_layers}

    for key, mode in part["modes"].items():
        params = packs[mode["pe_type"]] if mode["packed"] else dense
        _zero(torch, flash_attention, quant_matmul)
        t0 = time.perf_counter()
        got = vc.whisper_run(cut, params, mode, part, dev)
        wall = time.perf_counter() - t0
        counts = _counts(flash_attention, quant_matmul)
        if counts != per_run(cut, mode["packed"]):
            fail(f"whisper {key}: launches {counts}, expected "
                 f"{per_run(cut, mode['packed'])}")
        problems, notes = check.compare(got, mode["run"], WHISPER_TOL[key])
        for note in notes:
            print(f"  tolerated (whisper {key}): {note}")
        if problems:
            fail(f"whisper {key} differs from the JAX reference: "
                 + "; ".join(problems))
        err = check.max_logit_err(got, mode["run"])
        steps = check.compared_steps(got, mode["run"])
        out["runs"][key] = dict(launches=counts, wall_s=wall,
                                max_logit_err=err, steps_compared=steps,
                                tolerance=WHISPER_TOL[key], notes=len(notes))
        print(f"whisper ({cut.enc_layers} + {cut.dec_layers} layers) {key}: "
              f"matches the JAX reference (max logit err {err:.3g}, "
              f"tolerance {WHISPER_TOL[key]}, steps compared {steps}); "
              f"launches {counts}; {wall:.3f} s")
    del dense, packs
    gc.collect()

    # full width and depth, LightPE-1 codes, bfloat16
    t0 = time.perf_counter()
    packed = quantize_params(convert.params_from_numpy(
        encdec.numpy_params(full, vc.PARAM_SEED), dev), "lightpe1",
        min_size=part["min_size"])
    gc.collect()
    torch.cuda.synchronize()
    print(f"whisper: {full.name} at full width and depth ({full.enc_layers} "
          f"+ {full.dec_layers} layers, d_model {full.d_model}, "
          f"{full.n_heads} heads of {full.head_dim}, vocab {full.vocab}); "
          f"weights drawn and packed in {time.perf_counter() - t0:.2f} s")
    inputs = check.whisper_inputs(full.d_model, full.vocab)
    batch = {"frames": torch.as_tensor(inputs["frames"], device=dev),
             "tokens": torch.as_tensor(inputs["tokens"], device=dev)}
    cache = encdec.init_cache(full, check.WHISPER_BATCH,
                              check.WHISPER_MAX_LEN, torch.float32,
                              device=dev)
    _zero(torch, flash_attention, quant_matmul)
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache, enc = encdec.prefill(packed, batch, full, cache)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
        pre = _counts(flash_attention, quant_matmul)
        decode_ms = []
        toks = [logits[:, -1].argmax(-1)]
        for _ in range(vc.WHISPER_MAX_NEW - 1):
            _zero(torch, flash_attention, quant_matmul)
            t1 = time.perf_counter()
            logits, cache = encdec.decode_step(packed, toks[-1][:, None],
                                               enc, full, cache)
            toks.append(logits[:, -1].argmax(-1))
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t1) * 1e3)
            step = _counts(flash_attention, quant_matmul)
            want = {"flash_attention": 2 * full.dec_layers,
                    "quant_matmul": 10 * full.dec_layers}
            if step != want:
                fail(f"whisper full decode step: launches {step}, expected "
                     f"{want}")
    want = {"flash_attention": full.enc_layers + 2 * full.dec_layers,
            "quant_matmul": 6 * full.enc_layers + 10 * full.dec_layers}
    if pre != want:
        fail(f"whisper full prefill: launches {pre}, expected {want}")
    if not bool(torch.isfinite(logits).all()):
        fail("whisper full: logits not finite")
    tokens = torch.stack(toks, 1).cpu().numpy()
    # the greedy run at full depth held to the same run on the kernels'
    # plain versions (the JAX package's reference is cut to 4 + 4 layers)
    mode = part["modes"]["lightpe1"]
    shape = dict(batch=check.WHISPER_BATCH, frames=check.WHISPER_FRAMES,
                 prompt=check.WHISPER_PROMPT, max_len=check.WHISPER_MAX_LEN,
                 max_new=vc.WHISPER_MAX_NEW)
    _zero(torch, flash_attention, quant_matmul)
    got = vc.whisper_run(full, packed, mode, shape, dev)
    counts = _counts(flash_attention, quant_matmul)
    if counts != per_run(full, True):
        fail(f"whisper full record: launches {counts}, expected "
             f"{per_run(full, True)}")
    with plain_kernels(torch):
        plain = vc.whisper_run(full, packed, mode, shape, dev)
    if _counts(flash_attention, quant_matmul) != counts:
        fail("whisper full: the plain run launched a kernel")
    problems, notes = check.compare(got, plain, WHISPER_TOL["lightpe1"])
    for note in notes:
        print(f"  tolerated (whisper full / plain): {note}")
    if problems:
        fail("whisper full differs from its plain versions: "
             + "; ".join(problems))
    held = dict(max_logit_err=check.max_logit_err(got, plain),
                steps_compared=check.compared_steps(got, plain),
                tolerance=WHISPER_TOL["lightpe1"], notes=len(notes),
                tokens_equal=got["tokens"] == plain["tokens"])
    print(f"whisper full ({full.enc_layers} + {full.dec_layers} layers) "
          f"lightpe1 / its plain versions: matches (max logit err "
          f"{held['max_logit_err']:.3g}, tolerance {held['tolerance']}, "
          f"steps compared {held['steps_compared']}, tokens equal "
          f"{held['tokens_equal']})")
    out["full"] = dict(prefill_launches=pre, decode_launches=step,
                       prefill_ms=prefill_ms,
                       decode_ms=float(np.mean(decode_ms[1:])),
                       tokens0=tokens[0].tolist(), plain=held)
    print(f"whisper full (lightpe1, bfloat16, host-paced): prefill "
          f"{prefill_ms:.3f} ms (encoder 4 x 1500 + decoder 4 x 8; launches "
          f"{pre}), decode {out['full']['decode_ms']:.3f} ms/step (launches "
          f"{step}); tokens of row 0: {tokens[0].tolist()}")
    del packed, cache, enc
    gc.collect()
    return out


def check_variant_kernels(torch, dev):
    """Phase 12.6: the ``flash_attention`` kernel alone at phase 12's new
    shapes (``VARIANT_SHAPES``: Whisper's encoder and cross-attention at
    prefill and decode, no mask, Skv != Sq; block-local Gemma-3 at 2 x
    1024 with its window at head_dim 256; SmolLM ``attn_flash`` at 4 x
    2048), float32 q, K, V and float32 P as those paths give them, held
    to its plain version within ``FA_TOL``, two calls bitwise equal;
    timed beside the plain version, SDPA on the same function and its
    bound."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention import plan as fa_plan
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = []
    for name, b, sq, skv, hq, hkv, d, causal, window in VARIANT_SHAPES:
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev)
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        st = torch.zeros(b, dtype=torch.int32, device=dev)

        def kernel():
            return flash_attention_gqa(q, k, v, st, causal=causal,
                                       window=window)

        def plain():
            return ref_attention_gqa(q, k, v, st, causal, window=window)

        before = flash_attention.launches
        got, again = kernel(), kernel()
        launches = flash_attention.launches - before
        want = plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if launches != 2 or not torch.equal(got, again) \
                or not bool(torch.isfinite(got).all()) or err > FA_TOL:
            fail(f"flash_attention {name}: max_abs_err {err} (tolerance "
                 f"{FA_TOL}), {launches} launches for 2 calls, bitwise "
                 f"repeat {torch.equal(got, again)}")
        del got, again, want
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain, reps=3, warmup=1)
        tq, tk, tv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if window:
            pos = torch.arange(sq, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)
            kw = dict(attn_mask=mask)
        else:
            kw = dict(is_causal=causal)
        library_ms = time_ms(torch, lambda: sdpa(tq, tk, tv, enable_gqa=True,
                                                 **kw))
        del tq, tk, tv
        if causal:
            vis = [(max(0, i - window + 1) if window else 0, i + 1)
                   for i in range(sq)]
        else:
            vis = [(0, skv)] * sq
        bound, by, nbytes, _ = attention_bound(b, hq, hkv, d, vis, False)
        p = fa_plan(b, sq, skv, hq, hkv, d, False, window)
        rows.append(dict(name=name, b=b, sq=sq, skv=skv, hq=hq, hkv=hkv,
                         d=d, causal=causal, window=window, max_abs_err=err,
                         launches=launches, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound, bound_by=by,
                         bytes=nbytes, variant=p.variant, splits=p.splits))
        print(f"flash_attention {name} ({p.variant}, {p.splits} splits): "
              f"max_abs_err={err:.3g}, two calls bitwise equal; kernel "
              f"{ms:.4f} ms{_replaced(name, ms)}, plain {plain_ms:.4f} ms, "
              f"SDPA {library_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return rows


def run_variants(torch, dev, gemma_packs, gemma_records):
    """Phase 12: every attention path of the reference on the ported
    kernels (12.1-12.6)."""
    ref = json.loads(VARIANTS_REF.read_text())
    out = {}
    t0 = time.perf_counter()
    out["block_local"] = run_block_local(torch, dev, gemma_packs, ref)
    out["kv_replicated"] = run_kv_replicated(torch, dev, gemma_packs,
                                             gemma_records)
    gemma_packs.clear()
    gc.collect()
    print(f"phase 12.1-12.2 (gemma3-1b variants): "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    out["flash"] = run_flash_variant(torch, dev, ref)
    print(f"phase 12.3-12.4 (smollm-135m attn_flash, mixed precision): "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    out["whisper"] = run_whisper(torch, dev, ref)
    print(f"phase 12.5 (whisper-medium): {time.perf_counter() - t0:.2f} s")
    out["kernels"] = check_variant_kernels(torch, dev)
    return out


def check_zamba_kernel(torch, dev):
    """Phase 13.1: the flash_attention kernel at head_dim 112 (Zamba2-7B's
    shared attention, ``ZAMBA_ATTN_SHAPES``) against its plain version on
    the card: the served float32 q (the unified attention's) and a
    bfloat16 q, on the engine's float32 cache, float32 P; within
    ``FA_TOL``, two calls bitwise equal; timed beside the plain version,
    SDPA on the same function (``is_causal`` over the prompt's keys at
    prefill; every cached key at decode) and its bound."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention import plan as fa_plan
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for name, b, sq, skv, hq, hkv, d, start in ZAMBA_ATTN_SHAPES:
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        st = torch.full((b,), start, dtype=torch.int32, device=dev)
        for q_name in ("float32", "bfloat16"):
            q = torch.randn((b, sq, hq, d), generator=gen,
                            device=dev).to(getattr(torch, q_name))

            def kernel():
                return flash_attention_gqa(q, k, v, st)

            def plain():
                return ref_attention_gqa(q, k, v, st)

            before = flash_attention.launches
            got, again = kernel(), kernel()
            launches = flash_attention.launches - before
            want = plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if launches != 2 or not torch.equal(got, again) \
                    or not bool(torch.isfinite(got).all()) or err > FA_TOL:
                fail(f"flash_attention {name} q {q_name}: max_abs_err {err} "
                     f"(tolerance {FA_TOL}), {launches} launches for 2 "
                     f"calls, bitwise repeat {torch.equal(got, again)}")
            del got, again, want
            ms = time_ms(torch, kernel)
            plain_ms = time_ms(torch, plain, reps=3, warmup=1)
            seen = start + sq                   # the keys the rows see
            tq = q.float().transpose(1, 2).contiguous()
            tk, tv = (t[:, :seen].transpose(1, 2).contiguous()
                      for t in (k, v))
            library_ms = time_ms(torch, lambda: sdpa(
                tq, tk, tv, is_causal=sq > 1, enable_gqa=True))
            del tq, tk, tv
            bound, by, nbytes, _ = attention_bound(
                b, hq, hkv, d, [(0, start + i + 1) for i in range(sq)],
                q_name == "bfloat16")
            p = fa_plan(b, sq, skv, hq, hkv, d, q_name == "bfloat16")
            rows.append(dict(name=name, q_type=q_name, b=b, sq=sq, skv=skv,
                             hq=hq, hkv=hkv, d=d, start=start,
                             max_abs_err=err, launches=launches,
                             bitwise_repeat=True, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound,
                             bound_by=by, bytes=nbytes, variant=p.variant,
                             splits=p.splits, rows=p.rows))
            print(f"flash_attention {name} q {q_name} ({p.variant}, "
                  f"{p.rows} rows, {p.splits} splits): max_abs_err={err:.3g}, "
                  f"two calls bitwise equal; kernel {ms:.4f} ms"
                  f"{_replaced(f'{name}/{q_name}', ms)}, plain "
                  f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by})")
    return rows


def check_ssm_fake_quant(torch, dev, cfg, mod, params, ref):
    """The QAT numerics of an SSM / hybrid model on the card, element by
    element: under each QAT mode of the reference, the first layer's
    ``fake_quant_weight`` and ``fake_quant_act`` calls (caught in a
    prefill of the reference's prompts and one decode step; RWKV: its 8
    projections, Zamba2: a Mamba2 block's 2 and the first shared block's
    7) run again on the card (one launch each) and under
    ``plain_kernels`` (the plain version on the same tensor, its scale
    computed alike); 0 elements may differ.  Returns the calls checked,
    their elements and the prefill's weight calls' times."""
    import numpy as np
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.models import layers as L

    # the calls kept, by their index in a step (a weight and an
    # activation a projection): RWKV's first layer; Zamba2's first Mamba2
    # block and, after the group's 6, its shared block
    if cfg.family == "ssm":
        keep = set(range(2 * 8))
    else:
        first_shared = 2 * 2 * cfg.shared_attn_every
        keep = set(range(4)) | set(range(first_shared, first_shared + 14))
    lens = [len(pr) for pr in ref["prompts"]]
    toks = np.zeros((len(lens), max(lens)), np.int64)
    for i, pr in enumerate(ref["prompts"]):
        toks[i, -len(pr):] = pr
    toks = torch.as_tensor(toks, device=dev)
    fq_w, fq_a = L.fake_quant_weight, L.fake_quant_act
    out = dict(calls=0, elements=0, differing=0, weight_ms=0.0,
               weight_plain_ms=0.0)
    for key, m in ref["modes"].items():
        if m["pe_type"] == "fp32":
            continue
        run = cfg.replace(pe_type=m["pe_type"], dtype=m["dtype"])
        cache = mod.init_cache(run, len(lens), ref["max_len"], torch.float32,
                               device=dev)
        calls, seen = [], [0]

        def catch(fn, kind):
            def caught(x, qcfg):
                if seen[0] in keep:
                    calls.append((kind, x.detach(), qcfg))
                seen[0] += 1
                return fn(x, qcfg)
            return caught

        held = []
        L.fake_quant_weight = catch(fq_w, "weight")
        L.fake_quant_act = catch(fq_a, "act")
        try:
            logits, cache = mod.prefill(params, toks, run, cache)
            held += [("prefill", *c) for c in calls]
            calls.clear()
            seen[0] = 0
            nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
            mod.decode_step(params, nxt, run, cache)
            held += [("decode", *c) for c in calls if c[0] == "act"]
        finally:
            L.fake_quant_weight, L.fake_quant_act = fq_w, fq_a
        del cache, logits
        for phase, kind, x, qcfg in held:
            fn = fq_w if kind == "weight" else fq_a
            before = fake_quant.launches
            got = fn(x, qcfg)
            launches = fake_quant.launches - before
            with plain_kernels(torch):
                want = fn(x, qcfg)
            differing = int((got != want).sum())
            if launches != 1 or differing:
                fail(f"fake_quant {ref['config']} {key} {kind} "
                     f"{tuple(x.shape)} ({phase}): {launches} launches, "
                     f"{differing} elements differ from plain")
            out["calls"] += 1
            out["elements"] += x.numel()
            if kind == "weight" and phase == "prefill":
                out["weight_ms"] += time_ms(torch, lambda: fn(x, qcfg))
                with plain_kernels(torch):
                    out["weight_plain_ms"] += time_ms(
                        torch, lambda: fn(x, qcfg), reps=3, warmup=1)
            del got, want
        del held
    print(f"fake_quant at {ref['config']}'s shapes: {out['calls']} calls of "
          f"the first layer (weights and activations, prefill and decode), "
          f"{out['elements']} elements, 0 differ from plain; the first "
          f"layer's weights {out['weight_ms']:.4f} ms against plain "
          f"{out['weight_plain_ms']:.4f} ms (both QAT modes)")
    return out


def ssm_per_step(cfg) -> dict:
    """Kernel launches of one serving step of an SSM / hybrid model on
    dense weights under QAT numerics: ``fake_quant`` twice a projection
    (its weight and its activation), RWKV 8 projections a layer
    (r, k, v, g, o; the channel mix's k, r, v), Mamba2 2 (in, out), a
    shared block 7, and the head; ``flash_attention`` once a group (the
    shared block's attention)."""
    from repro_torch.models.hybrid import _group_shape
    if cfg.family == "ssm":
        return {"fake_quant": 2 * (8 * cfg.n_layers + 1),
                "flash_attention": 0}
    _, n_groups, _ = _group_shape(cfg)
    return {"fake_quant": 2 * (2 * cfg.n_layers + 7 * n_groups + 1),
            "flash_attention": n_groups}


def _ssm_counters():
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    return fake_quant, flash_attention, quant_matmul


def _ssm_want(cfg, max_new: int):
    per = ssm_per_step(cfg)

    def want(m):
        return {"fake_quant": 0 if m["pe_type"] == "fp32"
                else per["fake_quant"] * max_new,
                "flash_attention": per["flash_attention"] * max_new,
                "quant_matmul": 0}
    return want


def serve_full_depth(torch, dev, name, ref):
    """``name`` at full width and depth on dense float32 weights drawn on
    the card (``init_params``, seed ``param_seed``): for each mode of the
    reference, served on the kernels (launches counted exactly a step)
    and again on their plain versions (``plain_kernels``), the first held
    to the second at ``SSM_FULL_TOL``; then the LightPE-1 run warm: step
    latencies, tokens/s, peak memory."""
    import numpy as np
    from repro_torch.configs import get
    from repro_torch.models import family_module
    from repro_torch.serve import ServeEngine, check, packed_bytes

    cfg = get(name)
    mod = family_module(cfg)
    t0 = time.perf_counter()
    params = mod.init_params(
        cfg, torch.Generator(device=dev).manual_seed(ref["param_seed"]), dev)
    torch.cuda.synchronize()
    n_params = packed_bytes(params) // 4          # float32 leaves
    print(f"{name} full: {cfg.n_layers} layers, {n_params} parameters "
          f"({4 * n_params} B of float32) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    prompts = [np.array(p) for p in ref["prompts"]]
    counters = _ssm_counters()
    want = _ssm_want(cfg, ref["max_new"])
    out = {"n_layers": cfg.n_layers, "parameters": n_params,
           "per_step": ssm_per_step(cfg), "modes": {}}
    to_np = lambda t: t.float().cpu().numpy()  # noqa: E731
    for key, m in ref["modes"].items():
        run = cfg.replace(pe_type=m["pe_type"], dtype=m["dtype"])
        _zero(torch, *counters)
        t1 = time.perf_counter()
        got = check.record(ServeEngine(run, mod, params, ref["batch_slots"],
                                       ref["max_len"]),
                           prompts, ref["max_new"], to_np)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = _counts(*counters)
        if counts != want(m):
            fail(f"{name} full {key}: launches {counts}, expected "
                 f"{want(m)}")
        gc.collect()
        with plain_kernels(torch):
            _zero(torch, *counters)
            plain = check.record(ServeEngine(run, mod, params,
                                             ref["batch_slots"],
                                             ref["max_len"]),
                                 prompts, ref["max_new"], to_np)
            plain_counts = _counts(*counters)
        if any(plain_counts.values()):
            fail(f"{name} full {key}: the plain run launched {plain_counts}")
        coupled = m["pe_type"] != "fp32"
        problems, notes = check.compare(got, plain, SSM_FULL_TOL[key],
                                        coupled=coupled)
        if problems:
            fail(f"{name} full {key} differs from its plain versions: "
                 + "; ".join(problems))
        steps = check.compared_steps(got, plain, coupled)
        if not sum(steps):
            fail(f"{name} full {key}: no step compared with the plain run")
        held = dict(launches=counts, wall_s=wall,
                    max_logit_err=check.max_logit_err(got, plain, coupled),
                    tolerance=SSM_FULL_TOL[key], steps_compared=steps,
                    notes=len(notes), tokens_equal=got["tokens"]
                    == plain["tokens"], tokens0=got["tokens"][0])
        out["modes"][key] = held
        print(f"{name} full {key} / its plain versions: matches (max logit "
              f"err {held['max_logit_err']:.3g}, tolerance "
              f"{SSM_FULL_TOL[key]}, "
              f"steps compared {steps}, tokens equal "
              f"{held['tokens_equal']}); launches {counts}; {wall:.3f} s")
        gc.collect()

    eng = ServeEngine(cfg.replace(pe_type="lightpe1"), mod, params,
                      ref["batch_slots"], ref["max_len"])
    steps = {"prefill": [], "decode": []}

    def timed(step_name, fn):
        def step(p, t, c):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = fn(p, t, c)
            torch.cuda.synchronize()
            steps[step_name].append(time.perf_counter() - t1)
            return res
        return step

    eng._prefill = timed("prefill", eng._prefill)
    eng._decode = timed("decode", eng._decode)
    gc.collect()
    base = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    reqs = [eng.submit(p, max_new=ref["max_new"]) for p in prompts]
    eng.run()
    wall = time.perf_counter() - t1
    tokens = sum(len(r.out) for r in reqs)
    out.update(prefill_ms=steps["prefill"][0] * 1e3,
               decode_ms=float(np.mean(steps["decode"])) * 1e3,
               tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
               peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
               base_mib=base)
    print(f"{name} full lightpe1 (warm, host-paced): prefill "
          f"{out['prefill_ms']:.3f} ms (4 x {max(map(len, prompts))} "
          f"tokens), decode {out['decode_ms']:.3f} ms/step, {tokens} tokens "
          f"in {wall:.3f} s = {out['tokens_per_s']:.1f} tokens/s, peak "
          f"device memory {out['peak_mib']:.1f} MiB ({base:.1f} MiB before "
          f"the run)")
    del eng, params
    gc.collect()
    return out


def run_ssm_model(torch, dev, ref):
    """Phases 13.2 (RWKV6-1.6B) and 13.3 (Zamba2-7B): the model at full
    width with its depth cut as the reference cut it (RWKV 4 of 24 layers,
    Zamba2 13 of 81: both shared blocks and a tail of 1), on the
    reference's numpy weights, served by ``ServeEngine`` (4 prompts of
    8-130 tokens, 12 new tokens) in bfloat16 under the FP32 preset and the
    QAT numerics of LightPE-1 and INT8, held to the JAX package's runs in
    ``tests/data/torch_ssm_ref.json`` at ``SSM_TOL`` with exactly
    ``ssm_per_step`` ``fake_quant`` and ``flash_attention`` launches a
    step; then at full depth (``serve_full_depth``)."""
    from repro_torch import convert
    from repro_torch.configs import get
    from repro_torch.models import family_module
    from repro_torch.serve import ServeEngine, check

    name = ref["config"]
    cfg = get(name).replace(n_layers=ref["n_layers"])
    mod = family_module(cfg)
    t0 = time.perf_counter()
    params = convert.params_from_numpy(
        numpy_draw(mod, cfg, ref["param_seed"]), dev)
    torch.cuda.synchronize()
    print(f"{name}: full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}); dense weights {ref['dense_bytes']} B drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    fq = check_ssm_fake_quant(torch, dev, cfg, mod, params, ref)
    records = {}
    runs = serve_runs(
        torch, ref,
        lambda m: ServeEngine(cfg.replace(pe_type=m["pe_type"],
                                          dtype=m["dtype"]), mod, params,
                              ref["batch_slots"], ref["max_len"]),
        _ssm_counters(), _ssm_want(cfg, ref["max_new"]), SSM_TOL,
        coupled=lambda m: m["pe_type"] != "fp32", records=records)
    got, other = SSM_CONTROL
    problems, _ = check.compare(records[got], ref["modes"][other]["run4"],
                                SSM_TOL[got], coupled=True)
    if not problems:
        fail(f"{name}: the control passed: the {got} run is within "
             f"{SSM_TOL[got]} of the {other} reference")
    control = check.max_logit_err(records[got], ref["modes"][other]["run4"],
                                  True)
    print(f"{name} control: the {got} run against the {other} reference "
          f"fails, as it must ({control:.3g} > {SSM_TOL[got]})")
    del params, records
    gc.collect()
    return dict(cut=dict(n_layers=cfg.n_layers, per_step=ssm_per_step(cfg),
                         runs=runs, control_err=control, fake_quant=fq),
                full=serve_full_depth(torch, dev, name, ref))


def run_ssm_packed(torch, dev, ref):
    """Phase 13.4: a reduced model packed by the port's
    ``quantize_params`` as LightPE-1 and INT8 codes (the reference's
    packed leaves and bytes; the reference's pow2 codes pinned at log2
    ties), served on the card in bfloat16 and held to the JAX package's
    packed runs at ``SSM_PACKED_TOL``, with exactly one ``quant_matmul``
    launch a packed projection a step (RWKV: the channel mix's k and v a
    layer and the head; Zamba2: the tail's in_proj and the head) and one
    ``flash_attention`` a group."""
    from repro_torch import convert
    from repro_torch.configs import reduced
    from repro_torch.models import family_module
    from repro_torch.models.hybrid import _group_shape
    from repro_torch.serve import (ServeEngine, check, packed_bytes,
                                   quantize_params)

    name = ref["config"]
    cfg = reduced(name)
    mod = family_module(cfg)
    params = convert.params_from_numpy(
        numpy_draw(mod, cfg, ref["param_seed"]), dev)
    packs = {}
    for key, m in ref["modes"].items():
        packs[m["pe_type"]] = quantize_params(params, m["pe_type"],
                                              min_size=ref["min_size"])
        leaves = check.packed_leaves(packs[m["pe_type"]])
        if leaves != m["packed_leaves"] \
                or packed_bytes(packs[m["pe_type"]]) != m["packed_bytes"]:
            fail(f"{name} reduced {key}: packed {leaves}, "
                 f"{packed_bytes(packs[m['pe_type']])} B; the reference "
                 f"{m['packed_leaves']}, {m['packed_bytes']} B")
    pins = check.pin_pow2_codes(packs["lightpe1"], ref["pow2_ties"])
    del params
    n_packed = len(ref["modes"]["lightpe1"]["packed_leaves"])
    per_qmm = (2 * cfg.n_layers + 1 if cfg.family == "ssm"
               else _group_shape(cfg)[2] + 1)
    per_fa = 0 if cfg.family == "ssm" else _group_shape(cfg)[1]
    runs = serve_runs(
        torch, ref,
        lambda m: ServeEngine(cfg.replace(dtype=m["dtype"]), mod,
                              packs[m["pe_type"]], ref["batch_slots"],
                              ref["max_len"]),
        _ssm_counters(),
        lambda m: {"fake_quant": 0,
                   "flash_attention": per_fa * ref["max_new"],
                   "quant_matmul": per_qmm * ref["max_new"]},
        SSM_PACKED_TOL)
    return dict(packed_leaves=n_packed, quant_matmul_per_step=per_qmm,
                flash_attention_per_step=per_fa, pow2_pins=pins, runs=runs)


def run_ssm(torch, dev):
    """Phase 13: the SSM and hybrid families (13.1-13.4)."""
    ref = json.loads(SSM_REF.read_text())
    out = {"kernel_112": check_zamba_kernel(torch, dev)}
    for name, sub in (("rwkv6-1.6b", "13.2"), ("zamba2-7b", "13.3")):
        t0 = time.perf_counter()
        out[name] = run_ssm_model(torch, dev, ref["dense"][name])
        print(f"phase {sub} ({name}): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    out["packed"] = {name: run_ssm_packed(torch, dev, r)
                     for name, r in ref["packed"].items()}
    print(f"phase 13.4 (reduced models on codes): "
          f"{time.perf_counter() - t0:.2f} s")
    return out



# ---------------------------------------------------------------------------
# phase 14: the launch layer
# ---------------------------------------------------------------------------

LAUNCH_ARGV = ["--arch", "smollm-135m", "--pe-type", "lightpe1", "--steps",
               "3", "--batch", "16", "--seq", "256"]
LAUNCH_SERVE_ARGV = ["--arch", "gemma3-1b", "--pe-type", "lightpe1",
                     "--prompts", "4", "--prompt-len", "16", "--max-new", "16",
                     "--max-len", "128"]
# 14.4: the int8 payload against the float32 one.  Each exchanged value is
# rounded to one of 255 levels of its row's absmax (an error up to 1/254
# of it), the dispatch and the return of both MoE layers: an 8-bit
# rounding of the MoE layers' activations, as the INT8 QAT numerics
# round every activation, which phase 11.3 holds at 0.125 in bfloat16
EP_INT8_TOL = MOE_TOL["int8"]
# 14.3: |mean - g| <= scale / 2 in exact arithmetic; round(g32 / scale)
# decides on the float32 quotient (up to 127, within 2^-18 of the exact
# one) and q * scale is rounded once more, so a value at a half-step may
# land a few float32 ulps past it (the reference's test allows 1e-6 at
# unit scale)
HALF_STEP = 0.5 + 2.0 ** -16


def _launch_counters():
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    return fake_quant, flash_attention, quant_matmul


def _train_counts(fq, fa):
    return {"fake_quant": fq.launches, "flash_attention": fa.launches,
            "flash_attention_backward": fa.backward_launches}


def _zero_train(torch, fq, fa):
    torch.cuda.synchronize()
    fq.launches = fa.launches = fa.backward_launches = 0


def _states_differ(a, b) -> int:
    from repro_torch.optim import tree_leaves
    pa = tree_leaves(a.params) + tree_leaves(a.opt_state) + [a.step]
    pb = tree_leaves(b.params) + tree_leaves(b.opt_state) + [b.step]
    if len(pa) != len(pb):
        return -1
    return sum(int((x != y).sum()) for x, y in zip(pa, pb))


def launch_train(torch, dev, tmp):
    """14.1 and 14.2 (see ``run_launch``).  Returns the numbers, and the
    mesh step's parts and state for 14.3."""
    from repro_torch.configs import get
    from repro_torch.data import lm_pipeline
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as cli
    from repro_torch.models import family_module
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import (fit, init_state, jit_train_step,
                                   make_train_step, resume, shard_state,
                                   state_shardings_for)

    fq, fa, _ = _launch_counters()
    args = cli.parser().parse_args(LAUNCH_ARGV)
    steps = args.steps
    cfg = get(args.arch).replace(pe_type=args.pe_type)
    mod = family_module(cfg)

    def opt():
        return adamw(warmup_cosine(args.lr, 20, steps))

    def fresh(o):
        return init_state(cfg, mod, o, torch.Generator(device=dev)
                          .manual_seed(args.seed), device=dev)

    out = {}
    # 14.1: the CLI, one process (the plain trainer), against the trainer
    # driven directly with the same optimizer, schedule, seed and pipeline
    quiet = lambda _msg: None  # noqa: E731
    _zero_train(torch, fq, fa)
    t0 = time.perf_counter()
    state_cli = cli.main(LAUNCH_ARGV)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = _train_counts(fq, fa)
    want = {"fake_quant": steps * TRAIN_FQ_PER_STEP,
            "flash_attention": steps * TRAIN_FWD_PER_LAYER * cfg.n_layers,
            "flash_attention_backward": steps * cfg.n_layers}
    if counts != want:
        fail(f"launch.train: launches {counts}, want {want}")
    o = opt()
    state = fresh(o)
    step = make_train_step(cfg, mod, o)
    pipe = lm_pipeline(cfg, args.batch, args.seq, seed=args.seed, device=dev)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, next(pipe))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    direct = state
    differing = _states_differ(state_cli, direct)
    if differing:
        fail(f"launch.train differs from the trainer driven directly in "
             f"{differing} elements")
    out["train_cli"] = dict(argv=LAUNCH_ARGV, seconds=cli_s,
                            direct_step_ms=[t * 1e3 for t in times],
                            loss=m["loss"].item(), differing=0,
                            launches=counts,
                            per_step={k: v / steps for k, v in counts.items()})
    print(f"14.1 launch.train {' '.join(LAUNCH_ARGV)}: {cli_s:.2f} s (init "
          f"included), bitwise equal to the trainer driven directly (steps "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms); launches a "
          f"step {out['train_cli']['per_step']}")
    del state_cli, state, step, pipe
    gc.collect()

    # 14.2: the same run on a (1, 1) mesh: specs from state_shardings_for,
    # the per-process pipeline, the dp mean an NCCL all_reduce; a
    # checkpoint at step 2 and resume onto a fresh (1, 1) mesh
    mesh = M.make_mesh((1, 1), ("data", "model"), dev)
    o = opt()
    sh = state_shardings_for(cfg, mod, mesh, o)
    state = shard_state(fresh(o), sh)
    step = jit_train_step(make_train_step(cfg, mod, o), sh, mesh)
    pipe = lm_pipeline(cfg, args.batch, args.seq, seed=args.seed,
                       device=dev, mesh=mesh)
    ckpt_dir = str(Path(tmp) / "ckpt")
    mesh_times = []

    def timed(st, batch):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, mm = step(st, batch)
        torch.cuda.synchronize()
        mesh_times.append(time.perf_counter() - t1)
        return st, mm

    _zero_train(torch, fq, fa)
    state = fit(state, timed, pipe, steps - 1, ckpt_dir=ckpt_dir,
                ckpt_every=steps - 1, log_fn=quiet, shardings=sh)
    state = fit(state, timed, pipe, steps, log_fn=quiet, shardings=sh)
    counts = _train_counts(fq, fa)
    if counts != want:
        fail(f"the (1, 1) mesh step: launches {counts}, want {want}")
    differing = _states_differ(state, direct)
    if differing:
        fail(f"the (1, 1) mesh run differs from 14.1 in {differing} elements")
    mesh2 = M.make_mesh((1, 1), ("data", "model"), dev)
    o2 = opt()
    pipe2 = lm_pipeline(cfg, args.batch, args.seq, seed=args.seed,
                        device=dev, mesh=mesh2)
    back = resume(cfg, mod, o2, ckpt_dir, pipe2, device=dev, mesh=mesh2)
    if int(back.step) != steps - 1 or pipe2.state.step != steps - 1:
        fail(f"resume onto a fresh (1, 1) mesh restored step "
             f"{int(back.step)}, pipeline {pipe2.state.step}")
    sh2 = state_shardings_for(cfg, mod, mesh2, o2)
    step2 = jit_train_step(make_train_step(cfg, mod, o2), sh2, mesh2)
    back = fit(back, step2, pipe2, steps, log_fn=quiet, shardings=sh2)
    differing = _states_differ(back, direct)
    if differing:
        fail(f"the resumed step {steps} differs from 14.1 in {differing} "
             f"elements")
    out["mesh"] = dict(mesh=[1, 1], step_ms=[t * 1e3 for t in mesh_times],
                       differing=0, resumed_differing=0, launches=counts,
                       per_step={k: v / steps for k, v in counts.items()},
                       direct_step_ms=out["train_cli"]["direct_step_ms"])
    print(f"14.2 the (1, 1) mesh (NCCL): steps "
          f"{', '.join(f'{t * 1e3:.1f}' for t in mesh_times)} ms (directly: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), bitwise equal to "
          f"14.1; saved at step {steps - 1}, resumed onto a fresh (1, 1) "
          f"mesh: step {steps} bitwise equal")
    parts = step.parts
    del back, direct, pipe, pipe2, step2
    gc.collect()
    return out, (parts, mesh, sh, state, cfg, args)


def launch_grad_compress(torch, dev, parts, mesh, sh, state, cfg, args):
    """14.3 (see ``run_launch``)."""
    import torch.distributed as dist
    from repro_torch.data import lm_pipeline
    from repro_torch.launch.mesh import all_reduce
    from repro_torch.models.layers import activation_sharding
    from repro_torch.optim import tree_leaves, tree_unflatten
    from repro_torch.optim.grad_compress import (make_compressed_allreduce,
                                                 quantize, shared_scale)
    from repro_torch.train.trainer import _grads_and_loss

    full = state.params           # a (1, 1) mesh: every shard is the leaf
    batch = next(lm_pipeline(cfg, args.batch, args.seq, seed=args.seed,
                             device=dev, mesh=mesh))
    with activation_sharding(("data",), 1, mesh=mesh):
        flat, _ = _grads_and_loss(parts, full, batch)
    grads = tree_unflatten(full, flat)
    errs = tree_unflatten(full, [torch.zeros_like(g) for g in flat])
    f = make_compressed_allreduce(mesh, ("data",))
    mean, new_err = f(grads, errs)
    leaves, worst = 0, 0.0
    for g, mu, e in zip(flat, tree_leaves(mean), tree_leaves(new_err)):
        g32 = g.to(torch.float32)
        scale = shared_scale(torch.max(torch.abs(g32)))
        q = quantize(g32, scale)
        if not torch.equal(mu, q.to(torch.float32) * torch.div(
                scale, torch.tensor(1.0, device=dev))):
            fail("14.3: the mean is not the codes of round(g32 / scale)")
        worst = max(worst, float((mu - g32).abs().max()) / float(scale))
        if worst > HALF_STEP:
            fail(f"14.3: |mean - g| = {worst:.9g} scale > scale / 2 and "
                 f"the rounding of g32 / scale")
        if not torch.equal(e, g32 - mu):
            fail("14.3: new_err != g32 - mean")
        leaves += 1
    n = sum(g.numel() for g in flat)
    ms = time_ms(torch, lambda: f(grads, errs), reps=10, warmup=1,
                 queued=False)

    bufs = [g.clone() for g in flat]

    def plain():
        for b in bufs:
            all_reduce(b, mesh, ("data",), dist.ReduceOp.SUM)

    reduce_ms = time_ms(torch, plain, reps=10, warmup=1, queued=False)
    out = dict(leaves=leaves, elements=n, compressed_ms=ms, worst=worst,
               all_reduce_ms=reduce_ms, wire_bytes_int8=n,
               wire_bytes_float32=4 * n)
    print(f"14.3 make_compressed_allreduce over NCCL on SmolLM-135M's "
          f"gradients ({leaves} leaves, {n} elements): codes of round(g32 / "
          f"scale), |mean - g| <= {worst:.9g} scale and new_err == g32 - "
          f"mean on every leaf; {ms:.4f} ms against the float32 all_reduce's "
          f"{reduce_ms:.4f} ms (the world is one card: no wire)")
    return out


def launch_moe_ep(torch, dev, mesh, host_params):
    """14.4 (see ``run_launch``): phase 11.3's params, from the host."""
    import numpy as np
    from repro_torch.configs import get
    from repro_torch.launch.mesh import activation_sharding
    from repro_torch.models import family_module
    from repro_torch.models.moe import RoutePins, RouterLog
    from repro_torch.optim import tree_map
    from repro_torch.serve import ServeEngine, check

    params = tree_map(lambda t: t.to(dev), host_params)

    ref = json.loads(MOE_REF.read_text())
    m = ref["modes"]["fp32"]
    cfg = get(ref["config"]).replace(n_layers=ref["n_layers"],
                                     pe_type=m["pe_type"], dtype=m["dtype"])
    mod = family_module(cfg)
    fq, fa, qmm = _launch_counters()
    prompts = [np.array(p) for p in ref["prompts"]]

    def serve(c, ctx, log=None, pins=None, want=None):
        eng = ServeEngine(c, mod, params, ref["batch_slots"], ref["max_len"])
        _zero(torch, fq, fa, qmm)
        t0 = time.perf_counter()
        with ctx, (pins or contextlib.nullcontext()):
            rec = check.record(eng, prompts, ref["max_new"],
                               lambda t: t.float().cpu().numpy(),
                               router=log, pins=pins, want=want)
        torch.cuda.synchronize()
        return rec, time.perf_counter() - t0, _counts(fq, fa, qmm)

    # the baseline's routing recorded; the EP runs take its experts at its
    # router near ties (the random router is flat: the EP layer rounds its
    # shared experts' output to bfloat16 before the add, as the
    # reference's EP does, and moe_apply adds it in float32, so a later
    # layer's near ties may fall the other way)
    with RouterLog() as log:
        base, base_s, _ = serve(cfg, contextlib.nullcontext(), log=log)
    runs = {}
    for name, int8 in (("float32", False), ("int8", True)):
        c = cfg.replace(moe_ep_shard_map=True, moe_ep_int8_payload=int8)
        pins = RoutePins(ref["router_tol"])
        rec, secs, counts = serve(c, activation_sharding(("data",), 1,
                                                         mesh=mesh),
                                  pins=pins, want=base)
        runs[name] = dict(rec=rec, seconds=secs, launches=counts,
                          pinned=pins.pinned)
        want = {"fake_quant": 0, "flash_attention":
                cfg.n_layers * ref["max_new"], "quant_matmul": 0}
        if counts != want:
            fail(f"14.4 EP {name}: launches {counts}, want {want}")
    problems, _ = check.compare(runs["float32"]["rec"], base, MOE_TOL["fp32"])
    if problems:
        fail(f"14.4 EP (float32 payload) against moe_apply: {problems[:3]}")
    err32 = check.max_logit_err(runs["float32"]["rec"], base)
    problems, _ = check.compare(runs["int8"]["rec"], runs["float32"]["rec"],
                                EP_INT8_TOL)
    if problems:
        fail(f"14.4 EP int8 payload against the float32 payload: "
             f"{problems[:3]}")
    err8 = check.max_logit_err(runs["int8"]["rec"], runs["float32"]["rec"])
    control, _ = check.compare(runs["int8"]["rec"], runs["float32"]["rec"],
                               0.0)
    if not control:
        fail("14.4 control: the int8 payload run equals the float32 one: "
             "the payload was not quantized")
    out = dict(config=ref["config"], n_layers=ref["n_layers"], mesh=[1, 1],
               moe_apply_s=base_s,
               float32=dict(max_abs_err=err32, tol=MOE_TOL["fp32"],
                            seconds=runs["float32"]["seconds"],
                            router_pins=runs["float32"]["pinned"]),
               int8=dict(max_abs_err=err8, tol=EP_INT8_TOL,
                         seconds=runs["int8"]["seconds"],
                         router_pins=runs["int8"]["pinned"],
                         control_problems=len(control)),
               per_step=cfg.n_layers)
    print(f"14.4 EP MoE, {ref['config']} at full width ({ref['n_layers']} "
          f"layers), the (1, 1) mesh: float32 payload within {err32:.4g} of "
          f"moe_apply (tolerance {MOE_TOL['fp32']}), int8 payload within "
          f"{err8:.4g} of the float32 one (tolerance {EP_INT8_TOL}; the "
          f"control at 0 fails); the baseline's experts taken at "
          f"{runs['float32']['pinned']} / {runs['int8']['pinned']} router "
          f"near ties; runs {base_s:.2f} / "
          f"{runs['float32']['seconds']:.2f} / {runs['int8']['seconds']:.2f} "
          f"s (moe_apply / float32 / int8); {cfg.n_layers} flash_attention "
          f"launches a step")
    return out


def launch_serve(torch, dev):
    """14.5 (see ``run_launch``)."""
    import io

    import numpy as np

    from repro_torch.configs import get
    from repro_torch.launch import serve as cli
    from repro_torch.models import family_module
    from repro_torch.serve import (ServeEngine, dequantize_params,
                                   quantize_params)

    fq, fa, qmm = _launch_counters()
    args = cli.parser().parse_args(LAUNCH_SERVE_ARGV)
    gc.collect()
    base = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    _zero(torch, fq, fa, qmm)
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        reqs = cli.main(LAUNCH_SERVE_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(fq, fa, qmm)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    lines = text.getvalue().splitlines()
    for line in lines:
        print(f"  launch.serve: {line}")
    served = next(x for x in lines if x.startswith("served"))
    tok_s = float(served.split("(")[1].split(" tok/s")[0])
    iters = int(served.split(", ")[-1].split(" engine iters")[0])
    cfg = get(args.arch)
    want = {"fake_quant": 0, "flash_attention": cfg.n_layers * iters,
            "quant_matmul": 0}
    if counts != want:
        fail(f"14.5 launch.serve: launches {counts}, want {want}")
    # the engine on the same dequantized weights
    mod = family_module(cfg)
    params = dequantize_params(quantize_params(mod.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev),
        args.pe_type))
    eng = ServeEngine(cfg, mod, params, batch_slots=args.slots,
                      max_len=args.max_len)
    rng = np.random.default_rng(args.seed)
    mine = [eng.submit(rng.integers(0, cfg.vocab, size=args.prompt_len),
                       max_new=args.max_new) for _ in range(args.prompts)]
    eng.run()
    if [r.out for r in reqs] != [r.out for r in mine]:
        fail("14.5 launch.serve's tokens differ from the engine's on the "
             "same dequantized weights")
    out = dict(argv=LAUNCH_SERVE_ARGV, tokens_per_s=tok_s, iters=iters,
               seconds=wall, peak_mib=peak, base_mib=base, launches=counts,
               per_step=counts["flash_attention"] / iters,
               tokens=[r.out for r in reqs])
    print(f"14.5 launch.serve gemma3-1b at full width and depth: {tok_s} "
          f"tokens/s ({iters} engine steps, {wall:.2f} s with the init and "
          f"packing), peak device memory {peak:.1f} MiB ({base:.1f} MiB "
          f"before the run); tokens equal the "
          f"engine's on the same dequantized weights; "
          f"{out['per_step']:.0f} flash_attention launches a step")
    del params, eng
    gc.collect()
    return out


def run_launch(torch, dev, moe_params):
    """Phase 14: the launch layer on the card (see the module docstring):
    the process group is NCCL of world size 1, from a ``FileStore`` in a
    temporary directory, destroyed at the end of the phase."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch import mesh as M

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        M.init_process_group(dev, 0, 1,
                             store=dist.FileStore(str(Path(tmp) / "store"), 1),
                             timeout_s=300)
        try:
            t0 = time.perf_counter()
            numbers, (parts, mesh, sh, state, cfg, args) = launch_train(
                torch, dev, tmp)
            out.update(numbers)
            out["grad_compress"] = launch_grad_compress(
                torch, dev, parts, mesh, sh, state, cfg, args)
            del state
            gc.collect()
            out["train_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["moe_ep"] = launch_moe_ep(torch, dev, mesh, moe_params)
            out["moe_ep_s"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    t0 = time.perf_counter()
    out["serve_cli"] = launch_serve(torch, dev)
    out["serve_s"] = time.perf_counter() - t0
    return out


# Phase 15.  The step's temporary bytes (``op_analysis``: live storages
# allocated in the step) are held to the growth of max_memory_allocated
# over the step within this band: the caching allocator rounds each block
# up to 512 bytes, which the storages' own sizes do not.
DRY_MEM_BAND = 0.10
DRY_BATCH, DRY_SEQ = 16, 256            # 15.1: phase 10's training batch
DRY_TIMED = 5                           # 15.1: timed steps of each variant
DRY_DECODE_BATCH = 8                    # 15.2: decode_32k's batch cut to 8
DRY_DECODE_TIMED = 5                    # 15.2: timed steps
DRY_FLOPS_RTOL = 1e-9                   # 15.3 against the reference file
DRY_WORKERS = 7                         # 15.3's processes (8 CPU cores)
# 15.3: seconds a cell took on the card's host at pod16x16 (Zamba2-7B's
# and RWKV6's training: a CPU run of the (1, 1) cell, their chunk scans
# batched on meta), so that the workers take the long cells first; other
# training cells ~20 s, serving cells ~1 s
DRY_SECONDS = {("zamba2-7b", "prefill_32k"): 169,
               ("zamba2-7b", "train_4k"): 83,
               ("qwen2-vl-72b", "train_4k"): 64,
               ("qwen3-32b", "train_4k"): 57,
               ("rwkv6-1.6b", "prefill_32k"): 48,
               ("rwkv6-1.6b", "train_4k"): 16,
               ("gemma2-9b", "train_4k"): 45,
               ("gemma3-1b", "train_4k"): 40}
DRY_KEYS = ("flops", "bytes_out", "collectives", "launches")


def start_dryrun(tmp: Path):
    """15.3's workers, started before the kernels' build at a lower
    priority: every (arch, shape) cell on a (1, 1) and a pod16x16 ``meta``
    mesh (no card touched), the longest first; each worker claims the
    next cell free (an exclusive file a cell).  ``pause_dryrun`` stops
    them from phase 1 to 15.2, so that no timed phase shares the host's
    cores with them.  Returns the processes, their result files and the
    number of cells."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import list_archs
    from repro_torch.launch.shapes import SHAPES

    def seconds(cell):
        arch, shape, _ = cell
        return DRY_SECONDS.get((arch, shape),
                               20 if SHAPES[shape].kind == "train" else 1)

    cells = sorted(((a, s, m) for m in ("1x1", "pod16x16")
                    for a in list_archs() for s in SHAPES), key=seconds,
                   reverse=True)
    spec, claims = tmp / "cells.json", tmp / "claims"
    spec.write_text(json.dumps(cells))
    claims.mkdir()
    procs, outs = [], []
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    for w in range(DRY_WORKERS):
        out = tmp / f"dryrun{w}.jsonl"
        code = ("import json, os, torch\n"
                "os.nice(10)\n"
                "torch.set_num_threads(1)\n"
                "from repro_torch.launch import dryrun\n"
                f"for i, cell in enumerate(json.load(open({str(spec)!r}))):\n"
                "    try:\n"
                f"        os.close(os.open(os.path.join({str(claims)!r}, "
                "str(i)), os.O_CREAT | os.O_EXCL))\n"
                "    except FileExistsError:\n"
                "        continue\n"
                f"    dryrun.run_cells([cell], {str(out)!r})\n")
        with open(tmp / f"dryrun{w}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env,
                stdout=subprocess.DEVNULL, stderr=log))
        outs.append(out)
    return procs, outs, len(cells)


def pause_dryrun(workers, go: bool):
    """Stop (``go`` False) or continue 15.3's workers."""
    import signal
    for p in workers[0]:
        if p.poll() is None:
            p.send_signal(signal.SIGCONT if go else signal.SIGSTOP)


def _meta_mesh():
    from repro_torch.launch import dryrun as D
    return D.start_mesh((1, 1), ("data", "model"), 0, "meta")


def _nccl_mesh(torch, dev, tmp: Path):
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    if dist.is_initialized():
        dist.destroy_process_group()
    M.init_process_group(dev, 0, 1, store=dist.FileStore(
        str(tmp / f"store{time.monotonic_ns()}"), 1), timeout_s=300)
    return M.make_mesh((1, 1), ("data", "model"), dev)


def _same_counts(name, card, meta, launched):
    """The card's and the meta run's counts: equal, key for key; the
    card's launches those that the kernels' own counters saw."""
    bad = [k for k in DRY_KEYS if card[k] != meta[k]]
    if bad:
        fail(f"{name}: the card's counts differ from meta's in {bad}: "
             f"{ {k: (card[k], meta[k]) for k in bad} }")
    if card["launches"] != launched:
        fail(f"{name}: the analyzer counted launches {card['launches']}, "
             f"the kernels' counters {launched}")


def _in_band(name, temp, growth):
    if not abs(temp - growth) <= DRY_MEM_BAND * growth:
        fail(f"{name}: temporary bytes {temp} not within {DRY_MEM_BAND} of "
             f"the growth of max_memory_allocated, {growth}")
    return (temp - growth) / growth


def _launched(torch, fn):
    """``fn()`` with every kernel's launch counter set to 0 before it;
    (its result, the counters' launches after it, those not 0)."""
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    torch.cuda.synchronize()
    fake_quant.launches = quant_matmul.launches = 0
    flash_attention.launches = flash_attention.backward_launches = 0
    out = fn()
    counts = {"fake_quant": fake_quant.launches,
              "quant_matmul": quant_matmul.launches,
              "flash_attention": flash_attention.launches,
              "flash_attention_backward": flash_attention.backward_launches}
    return out, {k: v for k, v in counts.items() if v}


def _measured(torch, step, args):
    """``op_analysis`` of one ``step(*args)`` on the card, the kernels'
    own launch counts over it, and the growth of ``max_memory_allocated``
    over it."""
    from repro_torch.launch import op_analysis as OA
    gc.collect()
    torch.cuda.synchronize()
    # the earlier phases' cached blocks out of the way: a block taken from
    # the cache is not split below 1 MiB of slack and counts whole (a
    # 4 MiB tensor in a 4.9 MiB block read 22% over 15.2's step)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    (out, rep), launched = _launched(torch,
                                     lambda: OA.analyze(step, *args))
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - before
    return out, rep, launched, growth


def _train_cell(torch, device, mesh):
    """15.1's step and arguments on ``device``: the (1, 1) mesh step of
    SmolLM-135M, LightPE-1, AdamW, a 16 x 256 batch."""
    from repro_torch.configs import get
    from repro_torch.models import family_module
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import (init_state, jit_train_step,
                                   make_train_step, shard_state,
                                   state_shardings_for)
    cfg = get("smollm-135m").replace(pe_type="lightpe1")
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(3e-4, 20, TRAIN_STEPS))
    sh = state_shardings_for(cfg, mod, mesh, opt)
    gen = (torch.Generator(device=device) if device.type == "cuda"
           else torch.Generator()).manual_seed(0)
    state = shard_state(init_state(cfg, mod, opt, gen, device=device), sh)
    toks = torch.randint(0, cfg.vocab, (DRY_BATCH, DRY_SEQ + 1),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1].contiguous().to(device),
             "labels": toks[:, 1:].contiguous().to(device)}
    step = jit_train_step(make_train_step(cfg, mod, opt), sh, mesh)
    return cfg, step, state, batch


@contextlib.contextmanager
def _remat(name):
    """``layers.remat`` as it is ("remat") or the identity ("identity")."""
    from repro_torch.models import layers as L
    inner = L.remat
    if name == "identity":
        L.remat = lambda fn, *a: fn(*a)
    try:
        yield
    finally:
        L.remat = inner


def dry_train(torch, dev, tmp: Path):
    """15.1 (see the module docstring)."""
    from repro_torch.launch import op_analysis as OA
    from repro_torch.optim import tree_leaves

    mesh = _nccl_mesh(torch, dev, tmp)
    # one state each with each layer recomputed and with remat the
    # identity, from the same seed: the first step's peaks, then
    # DRY_TIMED steps of each, in turn, host-paced; every step of the two
    # bitwise equal
    names = ("remat", "identity")
    cells = {n: _train_cell(torch, dev, mesh)[1:] for n in names}
    peaks, times, last = {}, {n: [] for n in names}, {}
    for i in range(1 + DRY_TIMED):
        for name in names:
            step, state, batch = cells[name]
            with _remat(name):
                gc.collect()
                torch.cuda.synchronize()
                if i == 0:
                    torch.cuda.reset_peak_memory_stats()
                    before = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                if i == 0:
                    peaks[name] = torch.cuda.max_memory_allocated() - before
                else:
                    times[name].append((time.perf_counter() - t0) * 1e3)
            cells[name] = (step, state, batch)
            last[name] = [m["loss"], m["grad_norm"]] + tree_leaves(
                state.params) + tree_leaves(state.opt_state)
    differing = sum(int((a != b).sum()) for a, b in zip(last["remat"],
                                                        last["identity"]))
    if differing:
        fail(f"15.1: the steps with each layer recomputed differ from the "
             f"steps without in {differing} elements")
    del last, cells["identity"]
    p50 = {n: sorted(t)[len(t) // 2] for n, t in times.items()}
    # the counted step on the card, then the same step on a (1, 1) meta mesh
    step, state, batch = cells.pop("remat")
    (state, _), card, launched, growth = _measured(torch, step,
                                                   (state, batch))
    del state, step, batch
    gc.collect()
    _, meta_step, meta_state, meta_batch = _train_cell(
        torch, torch.device("meta"), _meta_mesh())
    _, meta = OA.analyze(meta_step, meta_state, meta_batch)
    _same_counts("15.1", card, meta, launched)
    temp = card["memory"]["temp_size_in_bytes"]
    off = _in_band("15.1", temp, growth)
    out = dict(config="smollm-135m", pe_type="lightpe1", batch=DRY_BATCH,
               seq=DRY_SEQ, mesh=[1, 1], differing=0,
               counts={k: card[k] for k in DRY_KEYS}, launched=launched,
               temp_bytes=temp, meta_temp_bytes=meta["memory"][
                   "temp_size_in_bytes"], growth_bytes=growth,
               temp_vs_growth=off, step_ms=times["remat"],
               identity_step_ms=times["identity"],
               step_ms_p50=p50["remat"],
               identity_step_ms_p50=p50["identity"],
               recompute_cost=p50["remat"] / p50["identity"] - 1,
               peak_remat_bytes=peaks["remat"],
               peak_identity_bytes=peaks["identity"],
               argument_bytes=card["memory"]["argument_size_in_bytes"])
    print(f"15.1 SmolLM-135M LightPE-1 {DRY_BATCH} x {DRY_SEQ} (1, 1) mesh: "
          f"card == meta: flops {card['flops']:.6e}, bytes_out "
          f"{card['bytes_out']:.6e}, collectives {card['collectives']}, "
          f"launches {card['launches']} (the kernels' counters alike); "
          f"{1 + DRY_TIMED} steps with each layer recomputed bitwise equal "
          f"to {1 + DRY_TIMED} without; p50 step {p50['remat']:.1f} ms "
          f"recomputed against {p50['identity']:.1f} ms without "
          f"({out['recompute_cost']:+.1%}; in turn, host-paced, "
          f"{DRY_TIMED} each); temp {temp / 2 ** 20:.1f} MiB (meta "
          f"{meta['memory']['temp_size_in_bytes'] / 2 ** 20:.1f}) against "
          f"growth {growth / 2 ** 20:.1f} MiB ({off:+.2%}); peak growth "
          f"{peaks['remat'] / 2 ** 20:.1f} MiB recomputed against "
          f"{peaks['identity'] / 2 ** 20:.1f} MiB without")
    return out


def _device_busy_ms(torch, fn) -> float:
    """The sum of the device's kernel and copy durations over one
    ``fn()`` (``torch.profiler``), or None where it records none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 if us else None


def dry_decode(torch, dev, tmp: Path):
    """15.2 (see the module docstring)."""
    from repro_torch.configs import get
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import op_analysis as OA
    from repro_torch.launch.shapes import SHAPES, ShapeSpec
    from repro_torch.models.transformer import layer_is_global

    cfg = get("gemma3-1b")
    base = SHAPES["decode_32k"]
    shape = ShapeSpec("decode_32k_b8", base.seq, DRY_DECODE_BATCH, "decode")

    def cell(device, mesh):
        step, args = D.serve_cell(cfg, shape, mesh, device)
        cache = args[-1]
        # the last row: every layer attends its whole window, the global
        # ones every row of the cache
        for part in [cache["scan"]] + cache["dense"]:
            part["index"] = [shape.seq - 1] * len(part["index"]) \
                if isinstance(part["index"], list) else shape.seq - 1
        return step, args

    step, args = cell(dev, _nccl_mesh(torch, dev, tmp))
    k = args[-1]["scan"]["k"]                   # (layers, B, S, Hkv, D)
    cache_bytes = 2 * k.numel() * k.element_size()
    # the least bytes the step moves: the weights and the tokens read
    # once, the K and V rows each layer sees (its window, or every row of
    # a global layer) read once, and every op's output written once
    weight_bytes = OA.storage_bytes(args[:-1])
    rows = [shape.seq if g else min(cfg.window, shape.seq)
            for g in layer_is_global(cfg)]
    cache_read = 2 * sum(rows) * k[0, :, 0].numel() * k.element_size()
    step(*args)                                  # warm
    _, card, launched, growth = _measured(torch, step, args)
    # host-paced: each step waits for the one before
    times = []
    for _ in range(DRY_DECODE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(times)[len(times) // 2]
    busy = _device_busy_ms(torch, lambda: step(*args))
    del step, args
    gc.collect()
    meta_step, meta_args = cell(torch.device("meta"), _meta_mesh())
    _, meta = OA.analyze(meta_step, *meta_args)
    _same_counts("15.2", card, meta, launched)
    temp = card["memory"]["temp_size_in_bytes"]
    off = _in_band("15.2", temp, growth)
    moved = weight_bytes + cache_read + card["bytes_out"]
    by_bytes = moved / H100_BYTES_PER_S * 1e3
    by_flops = card["flops"] / H100_BF16_FLOPS * 1e3
    out = dict(config="gemma3-1b", shape="decode_32k", batch=shape.batch,
               cache_bytes=cache_bytes, counts={k: card[k] for k in DRY_KEYS},
               launched=launched, temp_bytes=temp,
               meta_temp_bytes=meta["memory"]["temp_size_in_bytes"],
               growth_bytes=growth, temp_vs_growth=off,
               step_ms_host_paced=times, step_ms_host_paced_p50=wall,
               device_busy_ms=busy, weight_bytes=weight_bytes,
               cache_read_bytes=cache_read, bytes_moved=moved,
               bytes_ms=by_bytes,
               flops_ms=by_flops,
               argument_bytes=card["memory"]["argument_size_in_bytes"])
    busy_text = "not measured" if busy is None else f"{busy:.3f} ms"
    print(f"15.2 Gemma-3-1B decode_32k batch {shape.batch} (cache "
          f"{cache_bytes / 1e9:.2f} GB): card == meta: flops "
          f"{card['flops']:.6e}, bytes_out {card['bytes_out']:.6e}, launches "
          f"{card['launches']} (the kernels' counters alike); p50 step "
          f"{wall:.3f} ms host-paced ({DRY_DECODE_TIMED} steps), the "
          f"device busy {busy_text} of one step (profiler); bound: "
          f"{moved / 1e9:.3f} GB read and written (weights "
          f"{weight_bytes / 1e9:.3f}, cache rows seen "
          f"{cache_read / 1e9:.3f}) / 3.35 TB/s "
          f"{by_bytes:.3f} ms, flops / 989 TFLOP/s {by_flops:.3f} ms; temp "
          f"{temp / 2 ** 20:.1f} MiB against growth "
          f"{growth / 2 ** 20:.1f} MiB ({off:+.2%})")
    return out


def _gb(x) -> str:
    return f"{x / 1e9:.3f}"


def dry_cells(procs, outs, n_cells):
    """15.3 (see the module docstring): wait for the workers, hold the
    (1, 1) cells to the reference file, print the pod16x16 table."""
    from repro_torch.configs import get
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.shapes import SHAPES

    t0 = time.perf_counter()
    for p in procs:
        try:
            p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail("15.3: the dry-run workers did not finish within 600 s "
                 "of phase 15")
    waited = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        fail(f"15.3: dry-run workers exited {[p.returncode for p in procs]}")
    res = [json.loads(line) for o in outs if o.exists()
           for line in o.read_text().splitlines()]
    if len(res) != n_cells:
        fail(f"15.3: {len(res)} of {n_cells} cells counted")
    ref = json.loads(DRYRUN_REF.read_text())["full"]
    held, skipped, matvec = 0, 0, {}
    for r in res:
        if r["mesh"] != "1x1":
            continue
        want = ref[r["arch"]][r["shape"]]
        key = f"{r['arch']}/{r['shape']}"
        if want["status"] == "skipped" or r["status"] == "skipped":
            if want["status"] != r["status"]:
                fail(f"15.3 {key}: {r['status']}, the reference "
                     f"{want['status']}")
            skipped += 1
            continue
        if r["status"] != "ok":
            fail(f"15.3 {key}: {r.get('error')}")
        if r["memory"]["argument_size_in_bytes"] != \
                want["memory"]["argument_size_in_bytes"]:
            fail(f"15.3 {key}: argument bytes "
                 f"{r['memory']['argument_size_in_bytes']}, the reference "
                 f"{want['memory']['argument_size_in_bytes']}")
        # both without their matrix-vector part (``dryrun.reference_flops``)
        flops = D.reference_flops(get(r["arch"]), SHAPES[r["shape"]], r)
        want_flops = want["flops"] - want["matvec_flops"]
        if abs(flops - want_flops) > DRY_FLOPS_RTOL * want_flops \
                or r["matvec_flops"] < want["matvec_flops"]:
            fail(f"15.3 {key}: flops {flops} (matrix-vector "
                 f"{r['matvec_flops']}), the reference {want_flops} "
                 f"(matrix-vector {want['matvec_flops']})")
        if r["matvec_flops"]:
            matvec[key] = (r["matvec_flops"], want["matvec_flops"])
        held += 1
    print(f"15.3 (1, 1) meta mesh against tests/data/torch_dryrun_ref.json: "
          f"{held} cells held (FLOPs without the matrix-vector part rtol "
          f"{DRY_FLOPS_RTOL}, argument bytes exact), {skipped} skipped as "
          f"the reference; "
          f"matrix-vector FLOPs (port, reference): {matvec}; waited "
          f"{waited:.1f} s for the workers")
    table = []
    print("15.3 pod16x16, a device: arch shape status flops args_GB "
          "temp_GB all-gather_GB all-reduce_GB all-to-all_GB fits_80GB")
    for r in sorted((r for r in res if r["mesh"] == "pod16x16"),
                    key=lambda r: (r["arch"], r["shape"])):
        row = dict(arch=r["arch"], shape=r["shape"], status=r["status"])
        if r["status"] == "ok":
            c, m = r["collectives"], r["memory"]
            row.update(flops=r["flops"],
                       args_bytes=m["resident_argument_bytes"],
                       temp_bytes=m["temp_size_in_bytes"],
                       collectives={k: v for k, v in c.items()
                                    if not k.endswith("_count")},
                       fits_80gb=r["fits_80gb"], seconds=r["seconds"])
            print(f"  {r['arch']} {r['shape']} ok {r['flops']:.4e} "
                  f"{_gb(m['resident_argument_bytes'])} "
                  f"{_gb(m['temp_size_in_bytes'])} "
                  f"{_gb(c.get('all-gather', 0))} "
                  f"{_gb(c.get('all-reduce', 0))} "
                  f"{_gb(c.get('all-to-all', 0))} {r['fits_80gb']}")
        else:
            row["reason"] = r.get("error") or r.get("reason")
            print(f"  {r['arch']} {r['shape']} {r['status']}: "
                  f"{row['reason'][:100]}")
        table.append(row)
    return dict(held=held, skipped=skipped, matvec=matvec,
                waited_s=waited, cells=n_cells, pod16x16=table)


def run_dryrun(torch, dev, workers):
    """Phase 15 (see the module docstring): 15.1 and 15.2 with the
    workers stopped, then 15.3 with them running."""
    import tempfile

    import torch.distributed as dist
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            t0 = time.perf_counter()
            out["train"] = dry_train(torch, dev, Path(tmp))
            out["train_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["decode"] = dry_decode(torch, dev, Path(tmp))
            out["decode_s"] = time.perf_counter() - t0
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    pause_dryrun(workers, go=True)
    out["cells"] = dry_cells(*workers)
    return out


# Phase 16: every family trains on the card.  16.1: (name, b, s, hq, hkv,
# d, window, softcap, config) of the backward kernel at the models'
# training shapes (the scale is the config's); the reduced configs' head
# dims 16 (Whisper) and 32 (Gemma-3) at their reduced shapes
FAMILY_BWD_SHAPES = [
    ("gemma3_local", 2, 1024, 4, 1, 256, 512, 0.0, "gemma3-1b"),
    ("gemma3_global", 2, 1024, 4, 1, 256, 0, 0.0, "gemma3-1b"),
    ("gemma2_local", 1, 4608, 16, 8, 256, 4096, 50.0, "gemma2-9b"),
    ("gemma2_global", 1, 4608, 16, 8, 256, 0, 50.0, "gemma2-9b"),
    ("zamba2_shared", 2, 512, 32, 32, 112, 0, 0.0, "zamba2-7b"),
    ("whisper_reduced", 2, 64, 4, 4, 16, 0, 0.0, "whisper-medium"),
    ("gemma3_reduced", 2, 64, 2, 1, 32, 8, 0.0, "gemma3-1b"),
]
# 16.2-16.3: (config, its depth cut (config overrides), batch, seq,
# steps, PE type), AdamW; each held to the same steps on the kernels'
# plain versions at TRAIN_LM_RTOL.  Widths are full; depths are cut to
# what the kernels' checks need: Gemma-3-1B at 8 of 26 layers (a 5 local
# + 1 global period and 2 local layers: both windows), Gemma-2-9B at 4 of
# 42 (two local, two global; 4,608 tokens pass its 4,096 window);
# Zamba2-7B at 13 of 81 (two groups of six Mamba2 layers and a shared
# attention block each, both shared blocks, one tail layer); RWKV6-1.6B at
# 6 of 24 and Whisper-medium (head_dim 64; the encoder's frames are the
# pipeline's) at 6 + 6 of 24 + 24.  Gemma-3-1B again under FP32
# numerics: the kernels' difference from their plain versions without
# QAT's codes, which a float32 ulp can move by a level
FAMILY_TRAIN = [
    ("gemma3-1b", {"n_layers": 8}, 2, 1024, 3, "lightpe1"),
    ("gemma3-1b", {"n_layers": 8}, 2, 1024, 3, "fp32"),
    ("gemma2-9b", {"n_layers": 4}, 1, 4608, 3, "lightpe1"),
    ("zamba2-7b", {"n_layers": 13}, 2, 512, 3, "lightpe1"),
    ("rwkv6-1.6b", {"n_layers": 6}, 2, 256, 3, "lightpe1"),
    ("whisper-medium", {"enc_layers": 6, "dec_layers": 6}, 2, 256, 3,
     "lightpe1")]
FAMILY_REF = ROOT / "tests" / "data" / "torch_train_families_ref.json"


def _family_attention_calls(cfg) -> int:
    """Attention calls of one forward: every layer of a decoder, one a
    group of Zamba2's, none of RWKV's, and an encoder-decoder's encoder
    layers and two a decoder layer (self and cross)."""
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import _group_shape
        return _group_shape(cfg)[1]
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.dec_layers
    return cfg.n_layers


def check_family_backward(torch, dev):
    """Phase 16.1: the backward kernel's new instances at the models'
    training shapes, float32 and bfloat16, against the plain backward at
    phase 10.1's tolerances, two calls bitwise equal; timed beside the
    plain version and a library call's backward through autograd (SDPA,
    the window as a boolean mask; with the soft-cap ``flex_softcap``'s
    flex_attention), with their bounds."""
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import (WGMMA_DIMS,
                                                     attention_backward,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa_bwd
    from repro_torch.train_check import attention_grad_errors

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(16)
    rows = {}
    for name, b, s, hq, hkv, d, window, softcap, arch in FAMILY_BWD_SHAPES:
        scale = get(arch).query_scale or d ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
            do = torch.randn((b, s, hq, d), generator=gen, device=dev)
            st = torch.zeros(b, dtype=torch.int32, device=dev)
            kw = dict(scale=scale, round_p=True, window=window,
                      softcap=softcap)

            def kernel():
                return attention_backward(q, k, v, st, do, **kw)

            def plain():
                return ref_attention_gqa_bwd(q, k, v, st, do, True, scale,
                                             True, window, softcap)

            before = flash_attention.backward_launches
            got, again = kernel(), kernel()
            launches = flash_attention.backward_launches - before
            torch.cuda.synchronize()
            err = attention_grad_errors(got, plain(), do)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            key = f"{name}_{'f32' if dtype == torch.float32 else 'bf16'}"
            if not err["ok"] or not same or launches != 2:
                fail(f"16.1 backward {key}: {err}, two calls bitwise equal "
                     f"{same}, {launches} launches for 2 calls")
            del got, again
            ms = time_ms(torch, kernel)
            plain_ms = time_ms(torch, plain, reps=3, warmup=1)
            tq, tk, tv = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            t_lib = time.perf_counter()
            if not softcap:
                pos = torch.arange(s, device=dev)
                mask = pos[None, :] <= pos[:, None]
                if window:
                    mask &= pos[None, :] > pos[:, None] - window
                library = "SDPA backward, the window a mask"
                out = sdpa(tq, tk, tv, attn_mask=mask, scale=scale,
                           enable_gqa=True)
                del mask
            else:
                library = ("flex_attention backward (compiled; soft-cap, "
                           "window)")
                out = flex_softcap(torch, s, s, 0, window, softcap)(
                    tq, tk, tv, scale)
            tdo = do.transpose(1, 2).to(out.dtype)
            lib_grads = torch.autograd.grad(out, (tq, tk, tv), tdo,
                                            retain_graph=True)
            torch.cuda.synchronize()
            lib_s = time.perf_counter() - t_lib
            lib_err = attention_grad_errors(
                tuple(g.transpose(1, 2) for g in lib_grads),
                ref_attention_gqa_bwd(q, k, v, st, do, True, scale, False,
                                      window, softcap), do)["max_abs_err"]
            if dtype == torch.float32 and lib_err > LIBRARY_TOL:
                fail(f"16.1 {library} at {key}: max |err| {lib_err} against "
                     f"the plain backward, above {LIBRARY_TOL}")
            del lib_grads
            library_ms = time_ms(torch, lambda: torch.autograd.grad(
                out, (tq, tk, tv), tdo, retain_graph=True))
            del out, tq, tk, tv, tdo
            # the bound as phase 10.1's: each input read and each gradient
            # written once; the gradient's 5 products over the visible
            # (query head, key) pairs as kept bf16 part products
            pairs = b * hq * sum(min(i + 1, window) if window else i + 1
                                 for i in range(s))
            bf16 = dtype == torch.bfloat16
            nbytes = (2 * q.element_size() * (q.numel() + k.numel()
                                              + v.numel()) + 4 * do.numel())
            bound, by = bound_ms(nbytes, bwd_part_products(bf16, False) * 2
                                 * d * pairs, H100_BF16_FLOPS)
            rows[key] = dict(shape=[b, s, hq, hkv, d], dtype=str(dtype),
                             window=window, softcap=softcap, scale=scale,
                             max_abs_err=err["max_abs_err"], ms=ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             library=library, library_max_abs_err=lib_err,
                             library_first_call_s=lib_s,
                             bound_ms=bound, bound_by=by, pairs=pairs,
                             bound_share=bound / ms,
                             variant=("wgmma" if d in WGMMA_DIMS
                                      else "mma.sync"))
            lib = (f"{library} {library_ms:.4f} ms (max |err| {lib_err:.3g} "
                   f"vs plain; first call {lib_s:.1f} s)")
            print(f"16.1 backward {key} {[b, s, hq, hkv, d]} window {window} "
                  f"softcap {softcap}: max |err| {err['max_abs_err']:.3g} vs "
                  f"plain, two calls bitwise equal; kernel {ms:.4f} ms"
                  f"{_replaced(key, ms)}, plain {plain_ms:.4f} ms, {lib}; "
                  f"bound {bound:.4f} ms ({by}; {bound / ms:.1%} of it)")
            del q, k, v, do
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _family_steps(torch, dev, cfg, batch, seq, steps, plain: bool):
    """``steps`` AdamW steps of ``cfg`` from seed-0 params on the card on
    ``lm_pipeline``'s batches: [[loss, grad_norm], ...], the step times
    and the peak memory; on the kernels' plain versions with ``plain``."""
    from repro_torch.data import lm_pipeline
    from repro_torch.models import family_module
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train_check import LM_SCHEDULE

    mod = family_module(cfg)
    opt = adamw(warmup_cosine(*LM_SCHEDULE))
    state = init_state(cfg, mod, opt,
                       torch.Generator(device=dev).manual_seed(0), device=dev)
    step = make_train_step(cfg, mod, opt)
    pipe = lm_pipeline(cfg, batch, seq, device=dev)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, times = [], []
    with plain_kernels(torch) if plain else contextlib.nullcontext():
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, next(pipe))
            rows.append([m["loss"].item(), m["grad_norm"].item()])
            times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, step, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return rows, times, peak


def run_family_training(torch, dev):
    """Phases 16.2-16.3: each FAMILY_TRAIN model at full width and its cut
    depth, under its PE type, on the kernels with their launches
    counted exactly, then the same steps on the kernels' plain versions;
    the losses and gradient norms within TRAIN_LM_RTOL."""
    from repro_torch.configs import get
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import (WGMMA_DIMS,
                                                     flash_attention)
    from repro_torch.models.transformer import layer_is_global
    from repro_torch.train_check import compare

    out = {}
    for arch, layers, batch, seq, steps, pe in FAMILY_TRAIN:
        t0 = time.perf_counter()
        key = arch if pe == "lightpe1" else f"{arch}/{pe}"
        cfg = get(arch).replace(pe_type=pe, **layers)
        calls = _family_attention_calls(cfg)
        _zero(torch, flash_attention, fake_quant)
        flash_attention.backward_launches = 0
        flash_attention.wgmma_launches = 0
        flash_attention.backward_wgmma_launches = 0
        rows, times, peak = _family_steps(torch, dev, cfg, batch, seq, steps,
                                          False)
        counts = dict(flash_attention=flash_attention.launches,
                      flash_attention_backward=(
                          flash_attention.backward_launches),
                      fake_quant=fake_quant.launches,
                      flash_attention_wgmma=flash_attention.wgmma_launches,
                      flash_attention_backward_wgmma=(
                          flash_attention.backward_wgmma_launches))
        want = dict(flash_attention=2 * calls * steps,
                    flash_attention_backward=calls * steps)
        if {k: counts[k] for k in want} != want:
            fail(f"16 {key}: launches {counts}, want {want}")
        # the wide head_dims' prefill-shaped forwards and backwards run
        # the wgmma kernels, every one of them
        if calls and cfg.head_dim in WGMMA_DIMS and (
                counts["flash_attention_wgmma"] != 2 * calls * steps
                or counts["flash_attention_backward_wgmma"] != calls * steps):
            fail(f"16 {key}: the wgmma kernels ran {counts}, want every "
                 f"launch at head_dim {cfg.head_dim}")
        _zero(torch, flash_attention, fake_quant)
        flash_attention.backward_launches = 0
        plain_rows, plain_times, plain_peak = _family_steps(
            torch, dev, cfg, batch, seq, steps, True)
        if flash_attention.launches or flash_attention.backward_launches:
            fail(f"16 {key}: the plain run launched the kernels")
        held = compare(rows, plain_rows, TRAIN_LM_RTOL)
        if not held["ok"] or not all(math.isfinite(x) for r in rows
                                     for x in r):
            fail(f"16 {key}: the card's steps {rows} against the plain "
                 f"versions' {plain_rows}: {held}")
        p50 = sorted(times[1:])[len(times[1:]) // 2]
        windows = sorted({0 if g else cfg.window
                          for g in layer_is_global(cfg)}) \
            if cfg.family == "lm" else [0] * bool(calls)
        out[key] = dict(layers=layers, batch=batch, seq=seq, pe=pe,
                         steps=steps, rows=rows, plain_rows=plain_rows,
                         held=held, launches=counts, want=want,
                         step_ms=[t * 1e3 for t in times],
                         step_p50_ms=p50 * 1e3,
                         plain_step_ms=[t * 1e3 for t in plain_times],
                         peak_gib=peak, plain_peak_gib=plain_peak,
                         windows=windows,
                         seconds=time.perf_counter() - t0)
        print(f"16 {arch} ({layers}, {batch} x {seq}, "
              f"{pe}, AdamW, windows {windows}): {steps} steps "
              f"{[[round(x, 5) for x in r] for r in rows]}, plain "
              f"{[[round(x, 5) for x in r] for r in plain_rows]}: loss rel "
              f"{held['loss_rel']:.3g}, grad norm rel {held['gnorm_rel']:.3g} "
              f"(within {TRAIN_LM_RTOL}); launches {counts} (want {want}); "
              f"step p50 {p50 * 1e3:.1f} ms (plain "
              f"{sorted(plain_times)[len(plain_times) // 2] * 1e3:.1f}); "
              f"peak {peak:.2f} GiB (plain {plain_peak:.2f}); "
              f"{time.perf_counter() - t0:.1f} s")
    return out


def run_family_reference(torch, dev):
    """Phase 16.4: the reduced configs at the backward's new instances
    (``tests/data/torch_train_families_ref.json``'s cases: Gemma-3 at
    head_dim 32 and 256, Gemma-2 at 256 with its window and soft-cap,
    Zamba2 at 112) trained on the card, held to the JAX package's steps at
    TRAIN_LM_RTOL with exact launch counts; Gemma-2's run with the
    attention detached (the control) must fail."""
    from repro_torch import train_check as tc
    from repro_torch.configs import reduced
    from repro_torch.kernels.flash_attention import flash_attention

    ref = json.loads(FAMILY_REF.read_text())
    lm = ref["lm"]
    out = {}
    for name, case in ref["cases"].items():
        cfg = reduced(case["config"]).replace(dtype="float32",
                                              **case["overrides"])
        calls = _family_attention_calls(cfg)
        for pe, want_rows in case["runs"].items():
            _zero(torch, flash_attention)
            flash_attention.backward_launches = 0
            rows = tc.run_lm(cfg, pe, dev, batch=lm["batch"], seq=lm["seq"])
            counts = (flash_attention.launches,
                      flash_attention.backward_launches)
            want = (2 * calls * lm["steps"], calls * lm["steps"])
            held = tc.compare(rows, want_rows, TRAIN_LM_RTOL)
            if counts != want or not held["ok"]:
                fail(f"16.4 {name} {pe}: {held}, launches {counts}, want "
                     f"{want}")
            out[f"{name}/{pe}"] = dict(held, launches=list(counts))
            print(f"16.4 {name} {pe} (head_dim {cfg.head_dim}, window "
                  f"{cfg.window}, soft-cap {cfg.attn_softcap}): held to the "
                  f"JAX package, loss rel {held['loss_rel']:.3g}, grad norm "
                  f"rel {held['gnorm_rel']:.3g}; launches {counts}")
    case = ref["cases"]["gemma2-9b/hd256"]
    cfg = reduced(case["config"]).replace(dtype="float32",
                                          **case["overrides"])
    with tc.detached_attention():
        rows = tc.run_lm(cfg, "fp32", dev, batch=lm["batch"], seq=lm["seq"])
    control = tc.compare(rows, case["runs"]["fp32"], TRAIN_LM_RTOL)
    if control["ok"]:
        fail(f"16.4 control: Gemma-2 with its attention detached matches "
             f"the reference: {control}")
    out["control/detached"] = control
    print(f"16.4 control (Gemma-2, attention detached): outside the "
          f"tolerance, loss rel {control['loss_rel']:.3g}, grad norm rel "
          f"{control['gnorm_rel']:.3g}")
    return out


def run_families(torch, dev):
    """Phase 16 (see the module docstring)."""
    out = {}
    t0 = time.perf_counter()
    out["backward"] = check_family_backward(torch, dev)
    out["backward_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["train"] = run_family_training(torch, dev)
    out["train_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["reference"] = run_family_reference(torch, dev)
    out["reference_s"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 17: serving on an fp8 (float8_e4m3fn) K/V cache
# ---------------------------------------------------------------------------

FP8_REF = ROOT / "tests" / "data" / "torch_fp8_ref.json"
# 17.1: (name, b, sq, skv, hq, hkv, d, start, window, round_p, q_scale) of
# the kernels on e4m3 K and V, each with a float32 and a bfloat16 q:
# Qwen3-32B's decode (130 and 512 visible keys) and prefill (4 x 130)
# into a 32,768-row cache, Gemma-3-1B's windowed layer at head_dim 256,
# Zamba2-7B's shared attention at 112 and Whisper's decoder self-attention
# at 64 (both float32 P: round_p off), and decode_32k's step (batch 8 of
# 128, 32,768 keys, 16 replicated KV heads) on peaked logits (q scaled by
# 4: P keeps nonzero codes) and on near-uniform ones (logits N(0, 0.5^2),
# as the random seed model's: every P underflows to 0).  q, K, V N(0, 1),
# q times q_scale.
FP8_SHAPES = [
    ("qwen3-32b decode 130", 8, 1, 32768, 64, 8, 128, 129, 0, True, 1.0),
    ("qwen3-32b decode 512", 8, 1, 32768, 64, 8, 128, 511, 0, True, 1.0),
    ("qwen3-32b prefill", 4, 130, 32768, 64, 8, 128, 0, 0, True, 1.0),
    ("gemma3-1b decode", 4, 1, 1024, 4, 1, 256, 905, 512, True, 1.0),
    ("gemma3-1b prefill", 4, 900, 1024, 4, 1, 256, 0, 512, True, 1.0),
    ("zamba2-7b prefill", 4, 130, 256, 32, 32, 112, 0, 0, False, 1.0),
    ("zamba2-7b decode", 4, 1, 256, 32, 32, 112, 130, 0, False, 1.0),
    ("whisper decoder prefill", 4, 8, 448, 16, 16, 64, 0, 0, False, 1.0),
    ("whisper decoder decode", 4, 1, 448, 16, 16, 64, 8, 0, False, 1.0),
    ("whisper decoder 64 rows", 4, 64, 448, 16, 16, 64, 0, 0, False, 1.0),
    ("decode_32k peaked", 8, 1, 32768, 64, 16, 128, 32767, 0, True, 4.0),
    ("decode_32k near-uniform", 8, 1, 32768, 64, 16, 128, 32767, 0, True,
     0.5)]
FP8_UNDERFLOW = "decode_32k near-uniform"
# 17.2: the 2-layer run against tests/data/torch_fp8_ref.json.  The port
# on the CPU reads 0.0202 against it (max over the 9 steps' 64 columns;
# 0.0106 at the prefill: P codes and cache codes at e4m3 rounding ties
# flip between the packages' float32 sums, ``tests/_torch_fp8_ref.py
# --port``) and 26 in the L1 distance of layer 0's code histograms (13 of
# 655,360 codes one apart); the card read 0.0263 and 32 (this script's
# first run on an NVIDIA H100 80GB HBM3 at 700 W), so 0.05 and 128 (a
# cast that truncated would move half the codes).  The control, the same
# run on a float32 cache, must miss the reference (the card: 0.338).
FP8_REF_TOL = 0.05
FP8_CACHE_FLIPS = 128
# 17.2: Qwen3-32B at full width, FP8_LAYERS of its 64 layers (dense
# float32 weights drawn on the card), batch 8, a 32,768-row cache: v1b
# (8 KV heads) and v3 (int4 codes, 16 replicated KV heads), FP8_PROMPT
# tokens then FP8_STEPS decode steps on numpy tokens, each held to the
# same run on the kernels' plain versions.  Two correct runs sit apart
# there: a P at an e4m3 rounding tie takes codes a 1/16 step apart
# between the kernels' float32 P and the plain one's, and the bfloat16
# residual stream carries it on (the card read 0.0487 / 0.0841 for v1b /
# v3, this script's first run on an NVIDIA H100 80GB HBM3 at 700 W), so
# 0.2; the control, v1b's kernels on a float32 cache, must miss the plain
# fp8 run by more
FP8_LAYERS, FP8_BATCH, FP8_CACHE = 4, 8, 32768
FP8_PROMPT, FP8_STEPS = 130, 4
FP8_PLAIN_TOL = 0.2
FP8_VARIANTS = (("v1b_f8_cache_seqshard", {}, None),
                ("v3_f8_cache", {"kv_replicate_to": 16}, "int4"))


def fp8_attention_bound(b, hq, hkv, d, rows, q_bf16: bool, kv_bytes: int,
                        round_p: bool):
    """(bound ms, what bounds it, bytes) of the forward attention on a
    ``kv_bytes``-byte K/V cache: q and the float32 out once, the keys the
    rows see once (K and V); 2 D-long products a visible (query head, key)
    pair as kept bf16 part products (e4m3 or bf16 K and V one exact part;
    q float32 three; P three, or one when ``round_p`` rounds it to V's
    type)."""
    sq = len(rows)
    visible = sum(hi - lo for lo, hi in rows)
    keys = max(hi for _, hi in rows) - min(lo for lo, _ in rows)
    nbytes = (b * sq * hq * d * ((2 if q_bf16 else 4) + 4)
              + 2 * kv_bytes * b * keys * hkv * d)
    half = 2 * b * hq * d * visible
    qk = kept_part_products(1 if q_bf16 else 3, 1)
    pv = kept_part_products(1 if round_p else 3, 1)
    bound, by = bound_ms(nbytes, half * (qk + pv), H100_BF16_FLOPS)
    return bound, by, nbytes


def check_fp8_kernels(torch, dev):
    """Phase 17.1: every kernel instance on e4m3 K and V (``FP8_SHAPES``)
    against its plain version on the card, two calls bitwise equal: within
    ``FA_TOL``, plus, with ``round_p``, one e4m3 code step of P times |v|
    for each P the plain version holds within ``fp8_check.P_TIE_REL`` of a
    rounding midpoint (the kernels' float32 P differs from the plain one
    in the last bits, and such a P may round either way); the share of
    nonzero P codes printed with each result (nonzero in every compared
    case but the near-uniform one, where every P underflows and both
    outputs are exactly 0).  Timed beside the plain version, SDPA where it
    computes the same function (float32 P) and the bound; at decode_32k
    beside the same kernel on the cache in bfloat16, its bound, and SDPA
    on the bfloat16 cache (not the same function: P not rounded)."""
    from repro_torch import fp8_check as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention import plan as fa_plan
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa

    f8 = torch.float8_e4m3fn
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(17)
    rows, extra = [], {}
    for name, b, sq, skv, hq, hkv, d, start, window, round_p, q_scale \
            in FP8_SHAPES:
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(f8)
        v = torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(f8)
        st = torch.full((b,), start, dtype=torch.int32, device=dev)
        seen = start + sq                     # the keys the rows can see
        for q_name in ("float32", "bfloat16"):
            q = (torch.randn((b, sq, hq, d), generator=gen, device=dev)
                 * q_scale).to(getattr(torch, q_name))
            kw = dict(round_p=round_p, window=window)

            def kernel():
                return flash_attention_gqa(q, k, v, st, **kw)

            def plain():
                return ref_attention_gqa(q, k, v, st, True, 0.0, round_p,
                                         window)

            before = (flash_attention.launches, flash_attention.fp8_launches,
                      flash_attention.wgmma_launches)
            got, again = kernel(), kernel()
            launches = flash_attention.launches - before[0]
            fp8_l = flash_attention.fp8_launches - before[1]
            wgmma_l = flash_attention.wgmma_launches - before[2]
            want = plain()
            err = (got - want).abs()
            if round_p:
                ties = F.p_ties(q, k[:, :seen], v[:, :seen], st,
                                window=window)
                excess = float((err - ties["allowance"]).max())
                n_ties, share = ties["ties"], ties["nonzero_share"]
                del ties
            else:
                excess, n_ties, share = float(err.max()), 0, None
            max_err = float(err.max())
            p = fa_plan(b, sq, skv, hq, hkv, d, q_name == "bfloat16", window)
            if launches != 2 or fp8_l + wgmma_l != 2 \
                    or (wgmma_l == 2) != (p.variant == "wgmma") \
                    or not torch.equal(got, again) \
                    or not bool(torch.isfinite(got).all()) \
                    or excess > FA_TOL:
                fail(f"flash_attention fp8 {name} q {q_name}: max_abs_err "
                     f"{max_err}, {excess} past the tolerance {FA_TOL} and "
                     f"{n_ties} P's at ties; {launches} launches ({fp8_l} "
                     f"fp8, {wgmma_l} wgmma) for 2 calls, bitwise repeat "
                     f"{torch.equal(got, again)}")
            if name == FP8_UNDERFLOW:
                if share != 0.0 or bool(got.any()) or bool(want.any()):
                    fail(f"{name}: the near-uniform control has nonzero P "
                         f"codes ({share}) or outputs")
            elif round_p and not share:
                fail(f"{name} q {q_name}: no nonzero P code, the check "
                     f"would compare zeros")
            del got, again, want, err
            ms = time_ms(torch, kernel)
            plain_ms = time_ms(torch, plain, reps=3, warmup=1)
            library_ms = None
            if not round_p:   # float32 P: SDPA on the upcast cache
                tq = q.float().transpose(1, 2).contiguous()
                tk, tv = (t[:, :seen].float().transpose(1, 2).contiguous()
                          for t in (k, v))
                library_ms = time_ms(torch, lambda: sdpa(
                    tq, tk, tv, is_causal=sq > 1, enable_gqa=True))
                del tq, tk, tv
            lo = [max(0, start + i - window + 1) if window else 0
                  for i in range(sq)]
            spans = [(lo[i], start + i + 1) for i in range(sq)]
            bound, by, nbytes = fp8_attention_bound(
                b, hq, hkv, d, spans, q_name == "bfloat16", 1, round_p)
            row = dict(name=name, q_type=q_name, b=b, sq=sq, skv=skv, hq=hq,
                       hkv=hkv, d=d, start=start, window=window,
                       round_p=round_p, q_scale=q_scale, max_abs_err=max_err,
                       past_tolerance=excess, p_ties=n_ties,
                       p_nonzero_share=share, launches=launches,
                       bitwise_repeat=True, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound, bound_by=by,
                       bytes=nbytes, variant=p.variant, splits=p.splits,
                       rows=p.rows)
            rows.append(row)
            p_txt = (f"P codes nonzero {share:.4%} of the visible keys, "
                     f"{n_ties} at e4m3 ties" if round_p else "P float32")
            lib = f", SDPA {library_ms:.4f} ms" if library_ms else ""
            print(f"flash_attention fp8 {name} q {q_name} ({p.variant}, "
                  f"{p.rows} rows, {p.splits} splits): max_abs_err "
                  f"{max_err:.3g} ({p_txt}), two calls bitwise equal; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound "
                  f"{bound:.4f} ms ({by})")
            if name.startswith("decode_32k peaked") and q_name == "float32":
                extra = fp8_against_bf16(torch, q, k, v, st, ms, row, sdpa)
            del q
        del k, v
        gc.collect()
        torch.cuda.empty_cache()
    return rows, extra


def fp8_against_bf16(torch, q, k, v, st, fp8_ms, row, sdpa):
    """decode_32k: the kernel on the same cache in bfloat16 (exact: every
    e4m3 value is a bfloat16), its bound at 2 bytes a K/V element beside
    the fp8 one's at 1, and SDPA on the bfloat16 cache with a bfloat16 q
    (not the same function: P not rounded, q rounded)."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    bf16_ms = time_ms(torch, lambda: flash_attention_gqa(
        q, kb, vb, st, round_p=True))
    b, sq, hq, d = q.shape
    spans = [(0, int(st[0]) + 1)]
    bound16, by16, bytes16 = fp8_attention_bound(b, hq, k.shape[2], d, spans,
                                                 False, 2, True)
    tq = q.to(torch.bfloat16).transpose(1, 2).contiguous()
    tk, tv = (t.transpose(1, 2).contiguous() for t in (kb, vb))
    sdpa_ms = time_ms(torch, lambda: sdpa(tq, tk, tv, enable_gqa=True))
    del kb, vb, tq, tk, tv
    out = dict(fp8_ms=fp8_ms, fp8_bound_ms=row["bound_ms"],
               fp8_bytes=row["bytes"], bf16_cache_ms=bf16_ms,
               bf16_cache_bound_ms=bound16, bf16_cache_bound_by=by16,
               bf16_cache_bytes=bytes16, sdpa_bf16_cache_ms=sdpa_ms,
               sdpa_note="SDPA on the cache upcast to bfloat16 with a "
                         "bfloat16 q: not the same function (P not rounded)")
    print(f"decode_32k (8 x 1 x 64 heads, 16 KV heads of 128, 32,768 keys): "
          f"fp8 cache {fp8_ms:.4f} ms (bound {row['bound_ms']:.4f} ms, "
          f"{row['bytes'] / 1e6:.1f} MB), bfloat16 cache {bf16_ms:.4f} ms "
          f"(bound {bound16:.4f} ms, {bytes16 / 1e6:.1f} MB); SDPA on the "
          f"bfloat16 cache {sdpa_ms:.4f} ms (not the same function: P not "
          f"rounded)")
    return out


def _fp8_counters():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    return flash_attention, quant_matmul


def _fp8_counts():
    fa, qmm = _fp8_counters()
    return {"flash_attention": fa.launches, "fp8": fa.fp8_launches,
            "wgmma": fa.wgmma_launches, "quant_matmul": qmm.launches}


def _fp8_zero(torch):
    fa, qmm = _fp8_counters()
    torch.cuda.synchronize()
    fa.launches = fa.fp8_launches = fa.wgmma_launches = qmm.launches = 0


def run_fp8_reference(torch, dev):
    """Phase 17.2, against the JAX package: Qwen3-32B at full width, 2
    layers, the reference's weights (``fp8_check.hashed_params``, drawn on
    the card with the same bits), fed its greedy tokens on an fp8 cache; the launches counted exactly (2 a step: the prefill on the
    wgmma kernel, each decode step on the fp8 split kernel); the logits at
    the file's 64 columns within ``FP8_REF_TOL``, the argmax equal where
    the reference's top-2 margin exceeds twice that, layer 0's code
    histograms within ``FP8_CACHE_FLIPS``; the same run on a float32
    cache must miss the reference (the control)."""
    import numpy as np
    from repro_torch import fp8_check as F
    ref = json.loads(FP8_REF.read_text())
    cfg = F.config("full")
    t0 = time.perf_counter()
    params = F.hashed_params(cfg, F.PARAM_SEED, dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    prompt = F.prompt_tokens(cfg)
    greedy = np.asarray(ref["greedy"])
    _fp8_zero(torch)
    steps, cache = F.port_run(params, cfg, prompt, greedy, F.MAX_LEN, dev)
    launches = _fp8_counts()
    n = cfg.n_layers
    want_l = {"flash_attention": n * (1 + F.STEPS), "fp8": n * F.STEPS,
              "wgmma": n, "quant_matmul": 0}
    if launches != want_l:
        fail(f"fp8 reference run: launches {launches}, want {want_l}")
    got = F.summary(steps, F.columns(cfg), *F.layer0_bits(cache))
    del cache
    err = np.abs(np.asarray(got["logits"]) - np.asarray(ref["logits"]))
    margin = np.asarray(ref["margin"])
    sure = margin > 2 * FP8_REF_TOL
    argmax_ok = bool(np.all((np.asarray(got["argmax"])
                             == np.asarray(ref["argmax"])) | ~sure))
    hist = sum(int(np.abs(np.asarray(a) - np.asarray(b)).sum())
               for a, b in zip(got["cache_histogram"],
                               ref["cache_histogram"]))
    ctrl_steps, _ = F.port_run(params, cfg, prompt, greedy, F.MAX_LEN, dev,
                               torch.float32)
    cols = F.columns(cfg)
    ctrl_err = float(np.abs(ctrl_steps[..., cols]
                            - np.asarray(ref["logits"])).max())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(max_abs_err=float(err.max()),
               per_step=err.max(axis=(1, 2)).tolist(), argmax_ok=argmax_ok,
               cache_hash_equal=got["cache_sha256"] == ref["cache_sha256"],
               histogram_l1=hist, control_float32_cache_err=ctrl_err,
               launches=launches, draw_s=draw_s,
               p_nonzero_share_reference=ref["p_nonzero_share"])
    print(f"17.2 qwen3-32b ({n} layers, full width) on an fp8 cache against "
          f"the JAX package: max logit err {res['max_abs_err']:.4g} "
          f"(tolerance {FP8_REF_TOL}; the port on the CPU 0.0202), argmax "
          f"equal where sure {argmax_ok}, layer-0 cache hash equal "
          f"{res['cache_hash_equal']}, histogram L1 {hist} (within "
          f"{FP8_CACHE_FLIPS}); launches {launches}; control on a float32 "
          f"cache {ctrl_err:.4g} (must exceed the tolerance); weights drawn "
          f"in {draw_s:.1f} s")
    if res["max_abs_err"] > FP8_REF_TOL or not argmax_ok \
            or hist > FP8_CACHE_FLIPS:
        fail(f"fp8 reference run differs: {res}")
    if ctrl_err <= FP8_REF_TOL:
        fail(f"fp8 control: the float32-cache run is within the fp8 "
             f"reference's tolerance ({ctrl_err})")
    return res


def _fp8_serve(torch, dev, params, cfg, toks, plain: bool,
               cache_dtype=None):
    """Prefill of FP8_PROMPT tokens into a cache of FP8_CACHE rows (fp8,
    or ``cache_dtype``) and FP8_STEPS decode steps on the given tokens,
    on the kernels or their plain versions: (logits (1 + steps, B, V) on
    the card, step seconds host-paced, launches, peak bytes)."""
    from repro_torch.models import transformer as T
    ctx = plain_kernels(torch) if plain else contextlib.nullcontext()
    with ctx, torch.no_grad():
        cache = T.init_cache(cfg, FP8_BATCH, FP8_CACHE,
                             cache_dtype or torch.float8_e4m3fn, device=dev)
        _fp8_zero(torch)
        torch.cuda.reset_peak_memory_stats()
        out, secs = [], []
        for i in range(1 + FP8_STEPS):
            t0 = time.perf_counter()
            if i == 0:
                logits, cache = T.prefill(params, toks[:, :FP8_PROMPT], cfg,
                                          cache)
            else:
                at = FP8_PROMPT + i - 1
                logits, cache = T.decode_step(params, toks[:, at:at + 1],
                                              cfg, cache)
            out.append(logits[:, -1].float())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = _fp8_counts()
        peak = torch.cuda.max_memory_allocated()
        del cache
    return torch.stack(out), secs, launches, peak


def run_qwen3_fp8(torch, dev):
    """Phase 17.2 at full width: Qwen3-32B, ``FP8_LAYERS`` layers, batch
    8, a 32,768-row fp8 cache, as the perf variants ``v1b`` (dense float32
    weights, 8 KV heads) and ``v3`` (int4 codes, 16 replicated KV heads)
    serve it: the launches counted exactly (a layer's attention a step,
    the prefill's on the wgmma kernel, each decode step's on the fp8
    split kernel; v3's 7 projections a layer and the head on
    ``quant_matmul``), each run held to the same run on the kernels'
    plain versions, with its step times (host-paced), decode tokens/s and
    peak memory."""
    import numpy as np
    from repro_torch.configs import get
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import quantize_params
    base = get("qwen3-32b").replace(n_layers=FP8_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(0)
    dense = T.init_params(base, gen, device=dev)
    toks = torch.as_tensor(np.random.default_rng(17).integers(
        0, base.vocab, size=(FP8_BATCH, FP8_PROMPT + FP8_STEPS)), device=dev)
    runs = {}
    for vname, overrides, quant in FP8_VARIANTS:
        cfg = base.replace(**overrides)
        params = quantize_params(dense, quant) if quant else dense
        if quant:
            del dense
            gc.collect()
            torch.cuda.empty_cache()
        got, secs, launches, peak = _fp8_serve(torch, dev, params, cfg, toks,
                                               False)
        want, plain_secs, plain_launches, _ = _fp8_serve(
            torch, dev, params, cfg, toks, True)
        control = None
        if not quant:   # the kernels on a float32 cache
            ctrl, _, _, _ = _fp8_serve(torch, dev, params, cfg, toks, False,
                                       torch.float32)
            control = float((ctrl - want).abs().max())
            del ctrl
        n = cfg.n_layers
        want_l = {"flash_attention": n * (1 + FP8_STEPS),
                  "fp8": n * FP8_STEPS, "wgmma": n,
                  "quant_matmul": (7 * n + 1) * (1 + FP8_STEPS) if quant
                  else 0}
        zero = dict.fromkeys(want_l, 0)
        err = float((got - want).abs().max())
        finite = bool(torch.isfinite(got).all())
        del got, want
        decode_s = sum(secs[1:]) / FP8_STEPS
        res = dict(launches=launches, plain_launches=plain_launches,
                   max_abs_err=err, tolerance=FP8_PLAIN_TOL,
                   control_float32_cache_err=control,
                   prefill_ms=secs[0] * 1e3, decode_ms=decode_s * 1e3,
                   plain_prefill_ms=plain_secs[0] * 1e3,
                   plain_decode_ms=sum(plain_secs[1:]) / FP8_STEPS * 1e3,
                   decode_tokens_per_s=FP8_BATCH / decode_s,
                   peak_gib=peak / 2 ** 30)
        runs[vname] = res
        print(f"17.2 qwen3-32b {vname} ({n} layers, batch {FP8_BATCH}, "
              f"{FP8_CACHE}-row fp8 cache, {FP8_PROMPT} + {FP8_STEPS} "
              f"tokens): max logit err vs the plain kernels {err:.4g} "
              f"(tolerance {FP8_PLAIN_TOL}); launches {launches} (want "
              f"{want_l}); prefill {res['prefill_ms']:.1f} ms, decode step "
              f"{res['decode_ms']:.2f} ms host-paced = "
              f"{res['decode_tokens_per_s']:.1f} tokens/s (plain "
              f"{res['plain_decode_ms']:.2f} ms); peak "
              f"{res['peak_gib']:.2f} GiB"
              + ("" if control is None else f"; control on a float32 "
                 f"cache {control:.4g} (must exceed the tolerance)"))
        if launches != want_l or plain_launches != zero or not finite \
                or err > FP8_PLAIN_TOL \
                or (control is not None and control <= FP8_PLAIN_TOL):
            fail(f"fp8 {vname}: {res}, want launches {want_l}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def run_fp8(torch, dev):
    """Phase 17: the fp8 K/V cache on the card (17.1 the kernels, 17.2
    Qwen3-32B's serving against the JAX package and the plain kernels)."""
    t0 = time.perf_counter()
    kernels, decode_32k = check_fp8_kernels(torch, dev)
    t1 = time.perf_counter()
    reference = run_fp8_reference(torch, dev)
    variants = run_qwen3_fp8(torch, dev)
    t2 = time.perf_counter()
    return dict(kernels=kernels, decode_32k=decode_32k, reference=reference,
                variants=variants, kernels_s=t1 - t0, serve_s=t2 - t1,
                seconds=t2 - t0)


# 18.1: the tensor-parallel split on TP_RANKS ranks of one model group,
# both on the one card, each its own process (``repro_torch.launch.ranks``
# running ``repro_torch.tp_check``'s tasks, the launcher the CPU tests
# use) over gloo: NCCL refuses two ranks on one GPU, and gloo stages the
# card's tensors through the host.  Training: Gemma-3-1B at 16.2's depth,
# batch and steps under LightPE-1 (2 + 2 q heads over the replicated KV
# head, the MLP 3,456 columns a rank, the 262,144-row tied vocabulary
# split), the same under FP32 in float32 (the sum order's noise floor),
# and a control that must fail (``q_norm`` / ``k_norm`` not summed over
# the group: ``tp_check.variant("unsummed_norms")``); SmolLM-135M (9 / 3
# heads: its attention whole, each whole layer's weight gradients over
# the rank's half of the tokens, summed) beside the plain whole-layer
# step (``variant("whole_layers")``: every token on every rank, no
# collective), timed; serving: Qwen3-32B as 17.2's v3 (int4 codes, 16
# replicated KV heads split 8 + 8 with the fp8 cache).  Each held to the
# same run on one rank (``tp_check``'s runs without a mesh: the (1, 1)
# mesh step is the plain trainer bit for bit, 14.2): the steps at
# TRAIN_LM_RTOL (8-bit activation and pow2 codes at ties move with the
# sum order, as the plain kernels' do in 16.2), the params' change
# (``tp_check.change_gap`` on fixed elements of every leaf) within
# TP_PARAM_GAP (TP_FP32_GAP under FP32), every leaf equal on the two
# ranks bit for bit (a replicated leaf whose gradient is a rank's part
# parts the ranks), the launches a step and rank exactly the one rank's;
# the logits within FP8_PLAIN_TOL and the greedy tokens equal up to each
# row's first step whose top-2 margin is below it.  The gap limits:
# AdamW's first steps move an element by about lr times the sign of its
# gradient, so an element whose gradient is near 0 moves either way
# between two sum orders (one flip among a leaf's n elements reads
# 2 / sqrt(n)); on an NVIDIA H100 80GB HBM3 at 700 W the LightPE-1 splits
# read 0.1673 (Gemma-3-1B) and 0.1763 (SmolLM-135M), the FP32 split
# 5.367e-05, the control 0.8392 with 4 leaves parting the ranks
TP_RANKS = 2
TP_TRANSPORT = "gloo (two processes on the one card)"
TP_TRAIN = dict(name="train", kind="train", arch="gemma3-1b",
                overrides={"n_layers": 8, "pe_type": "lightpe1"}, batch=2,
                seq=1024, steps=3)
TP_FP32 = dict(TP_TRAIN, name="train_fp32", overrides={
    "n_layers": 8, "pe_type": "fp32", "dtype": "float32"})
TP_CONTROL = dict(TP_TRAIN, name="control", variant="unsummed_norms")
TP_SMOLLM = dict(name="smollm", kind="train", arch="smollm-135m",
                 overrides={"n_layers": 8, "pe_type": "lightpe1"}, batch=2,
                 seq=1024, steps=4)
TP_WHOLE = dict(TP_SMOLLM, name="smollm_whole", variant="whole_layers")
TP_SERVE = dict(name="serve", kind="serve", arch="qwen3-32b",
                overrides={"n_layers": FP8_LAYERS, "kv_replicate_to": 16},
                quant="int4", batch=FP8_BATCH, prompt=FP8_PROMPT,
                steps=FP8_STEPS, cache_rows=FP8_CACHE, token_seed=17)
TP_PARAM_GAP = 0.4
TP_FP32_GAP = 1e-3
TP_DEADLINE_S = 480
# 18.2: the kernels at pod16x16's local shapes: (name, b, sq, skv, hq, the
# KV heads of the cache, the one a rank reads, d, start, window, softcap,
# q scale); e4m3 K/V and a float32 q, round_p (v1b's dp-only fp8 cache,
# whose 8 KV heads do not divide 16: each rank's q heads read one of them
# as a strided view), Qwen3-32B's peaked at decode as 17.1's decode_32k
TP_SHAPES = [
    ("qwen3-32b decode_32k, rank 6", 8, 1, 32768, 4, 8, 3, 128, 32767, 0,
     0.0, 4.0),
    ("qwen3-32b prefill, rank 6", 2, 1024, 32768, 4, 8, 3, 128, 0, 0, 0.0,
     1.0),
    ("gemma2-9b decode_32k local layer, rank 6", 8, 1, 32768, 1, 8, 3, 256,
     32767, 4096, 50.0, 1.0)]
# the backward at Qwen3-32B's train_4k: a rank's 2 x 4,096 rows of a
# microbatch, 4 q heads over one of 8 replicated KV heads, float32
TP_BWD = ("qwen3-32b train_4k, rank 6", 2, 4096, 4, 8, 3, 128)


def check_tp_kernels(torch, dev):
    """Phase 18.2: the forward kernels on one KV head of a cache of eight
    (a strided view: no copy of the cache), held to the plain version
    within ``FA_TOL`` plus the allowance for P at e4m3 ties (17.1's), two
    calls bitwise equal, the memory a call takes beside the slice's
    bytes, timed beside the plain version and the bound; the backward at
    a rank's training shape within phase 10.1's tolerances."""
    from repro_torch import fp8_check as F
    from repro_torch.kernels.flash_attention import (attention_backward,
                                                     flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention import plan as fa_plan
    from repro_torch.kernels.flash_attention.ref import (
        ref_attention_gqa, ref_attention_gqa_bwd)
    from repro_torch.train_check import attention_grad_errors

    f8 = torch.float8_e4m3fn
    gen = torch.Generator(device=dev).manual_seed(18)
    rows = []
    for (name, b, sq, skv, hq, heads, j, d, start, window, softcap,
         q_scale) in TP_SHAPES:
        kc = torch.randn((b, skv, heads, d), generator=gen,
                         device=dev).to(f8)
        vc = torch.randn((b, skv, heads, d), generator=gen,
                         device=dev).to(f8)
        k, v = kc[:, :, j:j + 1], vc[:, :, j:j + 1]
        assert k.data_ptr() != kc.data_ptr() and not k.is_contiguous()
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev) * q_scale
        st = torch.full((b,), start, dtype=torch.int32, device=dev)
        kw = dict(round_p=True, window=window, softcap=softcap)

        def kernel():
            return flash_attention_gqa(q, k, v, st, **kw)

        def plain():
            return ref_attention_gqa(q, k, v, st, True, 0.0, True, window,
                                     softcap)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = flash_attention.launches
        got = kernel()
        torch.cuda.synchronize()
        took = torch.cuda.max_memory_allocated() - base
        again = kernel()
        launches = flash_attention.launches - before
        want = plain()
        seen = start + sq
        ties = F.p_ties(q, k[:, :seen], v[:, :seen], st, window=window,
                        softcap=softcap)
        err = (got - want).abs()
        excess = float((err - ties["allowance"]).max())
        max_err = float(err.max())
        p = fa_plan(b, sq, skv, hq, 1, d, False, window)
        slice_bytes = 2 * b * skv * d          # the rank's K and V, e4m3
        copied = p.variant != "wgmma" and took >= slice_bytes // 4
        if launches != 2 or not torch.equal(got, again) \
                or not bool(torch.isfinite(got).all()) or excess > FA_TOL \
                or not ties["nonzero_share"] or copied:
            fail(f"18.2 {name}: max_abs_err {max_err}, {excess} past "
                 f"{FA_TOL}; {launches} launches for 2; bitwise repeat "
                 f"{torch.equal(got, again)}; nonzero P share "
                 f"{ties['nonzero_share']}; {took} bytes taken beside a "
                 f"{slice_bytes}-byte slice")
        del got, again, want, err, ties
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain, reps=3, warmup=1)
        lo = [max(0, start + i - window + 1) if window else 0
              for i in range(sq)]
        bound, by, nbytes = fp8_attention_bound(
            b, hq, 1, d, [(lo[i], start + i + 1) for i in range(sq)], False,
            1, True)
        rows.append(dict(name=name, b=b, sq=sq, skv=skv, hq=hq,
                         cache_heads=heads, kv_head=j, d=d, start=start,
                         window=window, softcap=softcap, q_scale=q_scale,
                         max_abs_err=max_err, past_tolerance=excess,
                         bitwise_repeat=True, launches=launches,
                         bytes_taken=took, slice_bytes=slice_bytes, ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                         bound_by=by, bytes=nbytes, variant=p.variant,
                         splits=p.splits))
        print(f"18.2 flash_attention {name} ({b} x {sq} x {hq} q heads over "
              f"KV head {j} of {heads} as a view, {skv} e4m3 keys, "
              f"{p.variant}, {p.splits} splits): max_abs_err {max_err:.3g} "
              f"within FA_TOL past the P-tie allowance ({excess:.3g}), two "
              f"calls bitwise equal, {took} bytes taken beside the "
              f"{slice_bytes}-byte slice; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
        del q, k, v, kc, vc
        gc.collect()
        torch.cuda.empty_cache()

    name, b, s, hq, heads, j, d = TP_BWD
    qkv = [torch.randn((b, s, n, d), generator=gen, device=dev)
           for n in (hq, heads, heads)]
    q, k, v = qkv[0], qkv[1][:, :, j:j + 1], qkv[2][:, :, j:j + 1]
    dout = torch.randn((b, s, hq, d), generator=gen, device=dev)
    st = torch.zeros(b, dtype=torch.int32, device=dev)
    before = flash_attention.backward_launches

    def kernel_bwd():
        return attention_backward(q, k, v, st, dout, round_p=True)

    got, again = kernel_bwd(), kernel_bwd()
    launches = flash_attention.backward_launches - before
    want = ref_attention_gqa_bwd(q, k, v, st, dout, True, 0.0, True)
    held = attention_grad_errors(got, want, dout)
    if launches != 2 or not held["ok"] or not all(
            torch.equal(a, c) for a, c in zip(got, again)):
        fail(f"18.2 backward {name}: {held}, {launches} launches for 2")
    del got, again, want
    ms = time_ms(torch, kernel_bwd)
    plain_ms = time_ms(torch, lambda: ref_attention_gqa_bwd(
        q, k, v, st, dout, True, 0.0, True), reps=3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tq, tk, tv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    tdo = dout.transpose(1, 2).contiguous()
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa(tq, tk, tv, is_causal=True, enable_gqa=True), (tq, tk, tv),
        tdo))
    pairs = b * hq * s * (s + 1) // 2
    nbytes = 4 * (2 * q.numel() + 2 * dout.numel() + 4 * b * s * d)
    bound, by = bound_ms(nbytes, 2.0 * d * pairs
                         * bwd_part_products(False, False), H100_BF16_FLOPS)
    bwd = dict(name=name, b=b, s=s, hq=hq, cache_heads=heads, kv_head=j, d=d,
               max_abs_err=held["max_abs_err"], launches=launches, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library="SDPA forward and backward through autograd "
                       "(float32, is_causal, enable_gqa)",
               bound_ms=bound, bound_by=by)
    print(f"18.2 flash_attention backward {name} ({b} x {s}, {hq} q heads "
          f"over KV head {j} of {heads}, float32): max_abs_err "
          f"{held['max_abs_err']:.3g} within phase 10.1's tolerances, two "
          f"calls bitwise equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, SDPA forward + backward {library_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by})")
    del q, k, v, qkv, dout, tq, tk, tv, tdo
    gc.collect()
    torch.cuda.empty_cache()
    return rows, bwd


def _tp_ranks(tmp: Path, tasks) -> dict:
    """Every task on TP_RANKS ranks on the card over gloo: {task name:
    [(numbers, arrays) a rank]}.  A rank that fails, or outlives
    TP_DEADLINE_S, fails the phase (every rank stopped)."""
    from repro_torch.launch import ranks
    try:
        return ranks.run_ranks(TP_RANKS, tasks, tmp, device="cuda:0",
                               backend="gloo", deadline_s=TP_DEADLINE_S,
                               timeout_s=TP_DEADLINE_S)
    except RuntimeError as e:
        fail(f"18.1: {e}")


def _digests(arr, part):
    return {k[len(part) + 1:]: v for k, v in arr.items()
            if k.startswith(part + "/")}


def _tp_train_held(meta, arr, one, other) -> dict:
    """A rank's training run against the one-rank run ``one``: the steps
    at TRAIN_LM_RTOL, the params' change gap, the leaves that differ from
    the other rank's, the launches a step."""
    import numpy as np
    from repro_torch import tp_check
    from repro_torch.train_check import compare
    ref_meta, ref_arr = one
    final, theirs = _digests(arr, "final"), _digests(other, "final")
    return dict(
        held=compare(meta["rows"], ref_meta["rows"], TRAIN_LM_RTOL),
        param_gap=tp_check.change_gap(_digests(ref_arr, "start"), final,
                                      _digests(ref_arr, "final")),
        ranks_differ=sorted(k for k in final
                            if not np.array_equal(final[k], theirs[k])),
        finite=all(math.isfinite(x) for row in meta["rows"] for x in row),
        launches_equal=meta["launches"] == ref_meta["launches"])


def run_tp(torch, dev, tmp: Path):
    """Phase 18.1: the split's training and serving on TP_RANKS ranks of
    one model group against the same runs on one rank (the TP_TRAIN /
    TP_SERVE note)."""
    import numpy as np
    from repro_torch import tp_check

    print(f"18.1 transport: {TP_TRANSPORT}, {TP_RANKS} ranks of a (1, "
          f"{TP_RANKS}) ('data', 'model') mesh on {card_line()}")
    gc.collect()
    torch.cuda.empty_cache()
    one = {}
    for task in (TP_TRAIN, TP_FP32, TP_SMOLLM, TP_SERVE):
        one[task["name"]] = tp_check.run_task(task, dev, None)
        gc.collect()
        torch.cuda.empty_cache()
    ranks = _tp_ranks(tmp, [TP_TRAIN, TP_FP32, TP_CONTROL, TP_SMOLLM,
                            TP_WHOLE, TP_SERVE])

    res = {}
    for task, base in ((TP_TRAIN, "train"), (TP_FP32, "train_fp32"),
                       (TP_CONTROL, "train"), (TP_SMOLLM, "smollm"),
                       (TP_WHOLE, "smollm")):
        name = task["name"]
        (m0, a0), (m1, a1) = ranks[name]
        for r, (meta, arr, other) in enumerate(((m0, a0, a1),
                                                (m1, a1, a0))):
            h = _tp_train_held(meta, arr, one[base], other)
            gap = TP_FP32_GAP if task is TP_FP32 else TP_PARAM_GAP
            sound = h["held"]["ok"] and h["param_gap"] <= gap \
                and not h["ranks_differ"] and h["finite"] \
                and h["launches_equal"]
            if sound != (name != "control"):
                fail(f"18.1 {name} rank {r} "
                     f"{'passed, a control' if sound else 'failed'}: "
                     f"steps {meta['rows']} against one rank's "
                     f"{one[base][0]['rows']}: {h['held']}; params' change "
                     f"gap {h['param_gap']} (within {gap}); "
                     f"leaves differing between the ranks "
                     f"{h['ranks_differ']}; launches a step "
                     f"{meta['launches']}, one rank's "
                     f"{one[base][0]['launches']}")
            res[f"{name}_rank{r}"] = dict(
                rows=meta["rows"], param_gap=h["param_gap"],
                ranks_differ=h["ranks_differ"], step_ms=meta["step_ms"],
                peak_gib=meta["peak_gib"],
                launches_per_step=meta["launches"][-1], **h["held"])
        if name != "control":
            ref = one[base][0]
            res[f"{base}_one_rank"] = dict(
                rows=ref["rows"], step_ms=ref["step_ms"],
                peak_gib=ref["peak_gib"],
                launches_per_step=ref["launches"][-1])
        t, ref_rows = res[f"{name}_rank0"], one[base][0]["rows"]
        print(f"18.1 {name} {task['arch']} ({task['overrides']}, "
              f"{task['batch']} x {task['seq']}, AdamW, {task['steps']} "
              f"steps{', ' + task['variant'] if 'variant' in task else ''}) "
              f"on (1, {TP_RANKS}): rank 0 "
              f"{[[round(x, 5) for x in row] for row in t['rows']]}, one "
              f"rank {[[round(x, 5) for x in row] for row in one[base][0]['rows']]}: "
              f"loss rel {t['loss_rel']:.3g}, grad norm rel "
              f"{t['gnorm_rel']:.3g} (within {TRAIN_LM_RTOL}); params' "
              f"change gap {t['param_gap']:.4g} (within {gap}); "
              f"leaves differing between the ranks {len(t['ranks_differ'])} "
              f"{t['ranks_differ'][:4]}; step ms a rank "
              f"{[round(x, 1) for x in t['step_ms']]} (one rank "
              f"{[round(x, 1) for x in one[base][0]['step_ms']]}); peak "
              f"{t['peak_gib']:.2f} GiB a rank (one rank "
              f"{one[base][0]['peak_gib']:.2f}); launches a step and rank "
              f"{t['launches_per_step']}")
    split, whole = (float(np.median(res[f"{n}_rank0"]["step_ms"][1:]))
                    for n in ("smollm", "smollm_whole"))
    res["token_split_ms"], res["whole_layers_ms"] = split, whole
    print(f"18.1 smollm-135m a step after the first (median, rank 0): the "
          f"token split {split:.2f} ms, the plain whole-layer step "
          f"{whole:.2f} ms ({TP_TRANSPORT})")

    (ref_meta, ref_arr) = one["serve"]
    want = ref_arr["logits"]
    top2 = np.sort(want, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]            # (steps, B)
    for r, (meta, arr) in enumerate(ranks["serve"]):
        err = float(np.abs(arr["logits"] - want).max())
        # each row's tokens up to its first near tie
        sure = np.cumprod(margin > FP8_PLAIN_TOL, axis=0).astype(bool)
        same = bool((arr["greedy"] == np.argmax(want, -1))[sure].all())
        compared = int(sure.sum())
        finite = bool(np.isfinite(arr["logits"]).all())
        if err > FP8_PLAIN_TOL or not same or not finite or not compared \
                or meta["launches"] != ref_meta["launches"]:
            fail(f"18.1 serve rank {r}: max logit err {err} (within "
                 f"{FP8_PLAIN_TOL}), greedy tokens equal where sure {same} "
                 f"({compared} compared); launches {meta['launches']}, one "
                 f"rank's {ref_meta['launches']}")
        res[f"serve_rank{r}"] = dict(max_abs_err=err, tokens_compared=compared,
                                     step_ms=meta["step_ms"],
                                     peak_gib=meta["peak_gib"],
                                     launches=meta["launches"])
    res["serve_one_rank"] = dict(step_ms=ref_meta["step_ms"],
                                 peak_gib=ref_meta["peak_gib"],
                                 launches=ref_meta["launches"])
    s_ = res["serve_rank0"]
    print(f"18.1 serve qwen3-32b v3 ({TP_SERVE['overrides']}, int4 codes, a "
          f"{FP8_CACHE}-row fp8 cache, batch {FP8_BATCH}, {FP8_PROMPT} + "
          f"{FP8_STEPS} tokens) on (1, {TP_RANKS}): max logit err against one "
          f"rank {s_['max_abs_err']:.4g} (within {FP8_PLAIN_TOL}), greedy "
          f"tokens equal ({s_['tokens_compared']} of "
          f"{margin.size} row steps before a near tie); step ms a rank "
          f"{[round(x, 2) for x in s_['step_ms']]} (one rank "
          f"{[round(x, 2) for x in ref_meta['step_ms']]}); peak "
          f"{s_['peak_gib']:.2f} GiB a rank (one rank "
          f"{ref_meta['peak_gib']:.2f}); launches a rank {s_['launches']} "
          f"(one rank's: equal)")
    return res


def run_split(torch, dev):
    """Phase 18: the tensor-parallel split (18.1 two ranks of one model
    group on the card, 18.2 the kernels at pod16x16's local shapes)."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        runs = run_tp(torch, dev, Path(tmp))
    t1 = time.perf_counter()
    kernels, bwd = check_tp_kernels(torch, dev)
    t2 = time.perf_counter()
    return dict(transport=TP_TRANSPORT, runs=runs, kernels=kernels,
                backward=bwd, ranks_s=t1 - t0, kernels_s=t2 - t1,
                seconds=t2 - t0)


# 19.1: the sequence-sharded cache on SEQ_RANKS ranks of one model group,
# both on the one card, each its own process over gloo (18.1's launcher
# and transport): a cache whose KV heads do not divide the group splits
# its rows (``cache_spec(..., seq_shard=True)``), each rank writes the
# rows of its slice and attends over them, and the softmax is combined
# across the group (``layers.seq_attention``: the slice forms' stats
# launch, then with round_p on a bfloat16 or e4m3 cache the pass-2 launch
# under the group's (M, L)).  Gemma-3-1B at full width, SEQ_LAYERS of its
# 26 layers (one KV head; its 4 q heads split 2 + 2 and gathered for the
# attention), on a bfloat16 and on an e4m3 cache, and on int4 codes (so
# that quant_matmul runs on the path); SmolLM-135M at SEQ_LAYERS layers
# (3 KV heads over 2; its attention whole).  A prefill of SEQ_PROMPT
# tokens into a SEQ_CACHE-row cache (the prompt spans both slices) and
# SEQ_STEPS decode steps (written into the second slice).  Each held to
# the same run on one rank: the logits within SEQ_TOL (P codes round to
# the cache's type under the group's (M, L), which parts from one rank's
# in the last bits, so a code at a tie moves, as in 18.1's serving), the
# greedy tokens equal up to each row's first near tie, and the launches a
# rank exactly the one rank's with each attention launch a stats and a
# pass-2 launch (``seq_want``); step ms and peak memory a rank beside
SEQ_RANKS = 2
SEQ_LAYERS, SEQ_BATCH, SEQ_PROMPT, SEQ_STEPS, SEQ_CACHE = 8, 2, 300, 4, 512
SEQ_TOL = FP8_PLAIN_TOL
SEQ_GEMMA = dict(kind="serve", arch="gemma3-1b",
                 overrides={"n_layers": SEQ_LAYERS}, batch=SEQ_BATCH,
                 prompt=SEQ_PROMPT, steps=SEQ_STEPS, cache_rows=SEQ_CACHE,
                 token_seed=19)
SEQ_TASKS = [dict(SEQ_GEMMA, name="gemma_bf16", cache_dtype="bfloat16"),
             dict(SEQ_GEMMA, name="gemma_e4m3", cache_dtype="float8_e4m3fn"),
             dict(SEQ_GEMMA, name="gemma_int4", quant="int4",
                  cache_dtype="bfloat16"),
             dict(SEQ_GEMMA, name="smollm", arch="smollm-135m",
                  cache_dtype="bfloat16")]
# 19.2: the slice forms at pod16x16's local shapes: (name, b, sq, start,
# slices of keys, rows a slice, hq, hkv, d, q scale): Qwen3-32B's
# v1b_f8_cache_seqshard decode_32k (a rank's 8 rows, every q head
# gathered, 8 KV heads of 128, a 32,768-row e4m3 cache cut into 16
# slices of 2,048) on peaked logits, and a prefill slice on the wgmma
# kernel (2,048 queries, a sixteenth of prefill_32k's, against two
# slices of 2,048 keys: one whole, one on the diagonal)
SEQ_SHAPES = [("qwen3-32b decode_32k", 8, 1, 32767, 16, 2048, 64, 8, 128,
               4.0),
              ("qwen3-32b prefill slice", 1, 2048, 2048, 2, 2048, 64, 8, 128,
               1.0)]


def seq_slice_bound(b, hq, hkv, d, rows, pass2: bool):
    """(bound ms, what bounds it) of one slice's launch on an e4m3 cache
    with round_p, float32 q.  The two-pass stats launch reads q and the
    slice's K once and writes each row's (M, L); it forms Q K^T over the
    visible keys.  Pass 2 reads q, K, V and the group's (M, L) once and
    writes the float32 output; it forms Q K^T and P V.  Part products as
    ``fp8_attention_bound``'s (q three bf16 parts, K, V and the rounded P
    one).  ``rows``: each query's visible keys of the slice."""
    sq = len(rows)
    visible = sum(hi - lo for lo, hi in rows)
    keys = max(hi for _, hi in rows)
    stats = 2 * 4 * b * sq * hq
    nbytes = b * sq * hq * d * 4 + b * keys * hkv * d + stats
    flops = 2 * b * hq * d * visible * kept_part_products(3, 1)
    if pass2:
        nbytes += b * keys * hkv * d + b * sq * hq * d * 4
        flops += 2 * b * hq * d * visible * kept_part_products(1, 1)
    return bound_ms(nbytes, flops, H100_BF16_FLOPS)


def seq_want(one: dict) -> dict:
    """The launches a rank of the sequence split on a bfloat16 or e4m3
    cache makes where one rank made ``one``: each attention launch becomes
    a stats and a pass-2 launch of the same kernel."""
    fa = ("flash_attention", "flash_attention_wgmma", "flash_attention_fp8")
    want = {k: (2 * v if k in fa else v) for k, v in one.items()}
    want["flash_attention_stats"] = one["flash_attention"]
    want["flash_attention_pass2"] = one["flash_attention"]
    return want


def run_seq(torch, dev, tmp: Path):
    """Phase 19.1 (the SEQ_TASKS note)."""
    import numpy as np
    from repro_torch import tp_check
    from repro_torch.launch import ranks

    print(f"19.1 transport: {TP_TRANSPORT}, {SEQ_RANKS} ranks of a (1, "
          f"{SEQ_RANKS}) ('data', 'model') mesh on {card_line()}")
    one = {}
    for task in SEQ_TASKS:
        one[task["name"]] = tp_check.run_task(task, dev, None)
        gc.collect()
        torch.cuda.empty_cache()
    try:
        out = ranks.run_ranks(SEQ_RANKS, SEQ_TASKS, tmp, device="cuda:0",
                              backend="gloo", deadline_s=TP_DEADLINE_S,
                              timeout_s=TP_DEADLINE_S)
    except RuntimeError as e:
        fail(f"19.1: {e}")
    res = {}
    for task in SEQ_TASKS:
        name = task["name"]
        ref_meta, ref_arr = one[name]
        want = ref_arr["logits"]
        top2 = np.sort(want, axis=-1)[..., -2:]
        sure = np.cumprod(top2[..., 1] - top2[..., 0] > SEQ_TOL,
                          axis=0).astype(bool)
        want_launches = seq_want(ref_meta["launches"])
        for r, (meta, arr) in enumerate(out[name]):
            err = float(np.abs(arr["logits"] - want).max())
            same = bool((arr["greedy"] == np.argmax(want, -1))[sure].all())
            finite = bool(np.isfinite(arr["logits"]).all())
            if err > SEQ_TOL or not same or not finite or not sure.any() \
                    or meta["launches"] != want_launches:
                fail(f"19.1 {name} rank {r}: max logit err {err} (within "
                     f"{SEQ_TOL}), greedy tokens equal where sure {same} "
                     f"({int(sure.sum())} compared); launches "
                     f"{meta['launches']}, want {want_launches}")
            res[f"{name}_rank{r}"] = dict(
                max_abs_err=err, tokens_compared=int(sure.sum()),
                step_ms=meta["step_ms"], peak_gib=meta["peak_gib"],
                launches=meta["launches"])
        res[f"{name}_one_rank"] = dict(step_ms=ref_meta["step_ms"],
                                       peak_gib=ref_meta["peak_gib"],
                                       launches=ref_meta["launches"])
        t = res[f"{name}_rank0"]
        print(f"19.1 {name} {task['arch']} ({task['overrides']}, "
              f"{task.get('quant') or 'dense'}, a {SEQ_CACHE}-row "
              f"{task['cache_dtype']} cache split {SEQ_RANKS} ways, batch "
              f"{SEQ_BATCH}, {SEQ_PROMPT} + {SEQ_STEPS} tokens): max logit "
              f"err against one rank {t['max_abs_err']:.4g} (within "
              f"{SEQ_TOL}), greedy tokens equal ({t['tokens_compared']} of "
              f"{sure.size} row steps before a near tie); step ms a rank "
              f"{[round(x, 2) for x in t['step_ms']]} (one rank "
              f"{[round(x, 2) for x in ref_meta['step_ms']]}); peak "
              f"{t['peak_gib']:.2f} GiB a rank (one rank "
              f"{ref_meta['peak_gib']:.2f}); launches a rank {t['launches']}")
    return res


def check_seq_kernels(torch, dev):
    """Phase 19.2: the SEQ_SHAPES slices' stats and pass-2 launches,
    combined by the model's own combine (``layers.seq_attention``, one
    thread a slice over ``mesh.ThreadGroup``), held to the unsharded
    kernel and to the plain version within FA_TOL plus the allowance for
    P at e4m3 ties (17.1's); one slice's launches timed beside the plain
    slice forms and the bound."""
    import concurrent.futures
    from repro_torch import fp8_check as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_gqa, flash_attention_pass2,
        flash_attention_stats)
    from repro_torch.kernels.flash_attention import plan as fa_plan
    from repro_torch.kernels.flash_attention.ref import (
        ref_attention_gqa, ref_attention_pass2, ref_attention_stats)
    from repro_torch.launch.mesh import ThreadGroup
    from repro_torch.models import layers as L

    f8 = torch.float8_e4m3fn
    gen = torch.Generator(device=dev).manual_seed(19)
    rows = []
    for name, b, sq, start, n, per, hq, hkv, d, q_scale in SEQ_SHAPES:
        skv = n * per
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(f8)
        v = torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(f8)
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev) * q_scale
        st = torch.full((b,), start, dtype=torch.int32, device=dev)
        group = ThreadGroup(n)
        before = (flash_attention.stats_launches,
                  flash_attention.pass2_launches)

        def one_slice(i):
            with torch.cuda.device(dev):
                return L.seq_attention(
                    q, k[:, i * per:(i + 1) * per],
                    v[:, i * per:(i + 1) * per], st - i * per,
                    group.member(i), round_p=True)
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            outs = list(pool.map(one_slice, range(n)))
        torch.cuda.synchronize()
        launched = (flash_attention.stats_launches - before[0],
                    flash_attention.pass2_launches - before[1])
        got = outs[0]
        same = all(torch.equal(o, got) for o in outs[1:])
        whole = flash_attention_gqa(q, k, v, st, round_p=True)
        want = ref_attention_gqa(q, k, v, st, True, 0.0, True)
        ties = F.p_ties(q, k[:, :start + sq], v[:, :start + sq], st)
        err = (got - want).abs()
        excess = float((err - ties["allowance"]).max())
        kernel_gap = float((got - whole).abs().max())
        kernel_excess = float(((got - whole).abs()
                               - 2 * ties["allowance"]).max())
        max_err = float(err.max())
        nonzero = ties["nonzero_share"]
        # (the counters are not locked: threads may lose an increment)
        if min(launched) < 1 or not same or excess > FA_TOL \
                or kernel_excess > FA_TOL or not nonzero \
                or not bool(torch.isfinite(got).all()):
            fail(f"19.2 {name}: max_abs_err {max_err} ({excess} past "
                 f"{FA_TOL} and the P-tie allowance), against the unsharded "
                 f"kernel {kernel_gap} ({kernel_excess} past); launches "
                 f"{launched} of ({n}, {n}); slices agree {same}; nonzero P "
                 f"share {nonzero}")
        del outs, whole, want, err, ties
        # one slice's launches: the last one that the queries reach
        i = min(n - 1, start // per)
        ks, vs = k[:, i * per:(i + 1) * per], v[:, i * per:(i + 1) * per]
        s_st = st - i * per
        _, stats = flash_attention_stats(q, ks, vs, s_st, round_p=True)
        stats_ms = time_ms(torch, lambda: flash_attention_stats(
            q, ks, vs, s_st, round_p=True))
        pass2_ms = time_ms(torch, lambda: flash_attention_pass2(
            q, ks, vs, s_st, stats, round_p=True))
        stats_plain_ms = time_ms(torch, lambda: ref_attention_stats(
            q, ks, vs, s_st, True, 0.0, True), reps=3, warmup=1)
        pass2_plain_ms = time_ms(torch, lambda: ref_attention_pass2(
            q, ks, vs, s_st, stats, True, 0.0, True), reps=3, warmup=1)
        vis = [(0, min(per, start - i * per + r + 1)) for r in range(sq)]
        stats_bound, stats_by = seq_slice_bound(b, hq, hkv, d, vis, False)
        pass2_bound, pass2_by = seq_slice_bound(b, hq, hkv, d, vis, True)
        p = fa_plan(b, sq, per, hq, hkv, d, False, 0)
        rows.append(dict(name=name, b=b, sq=sq, start=start, slices=n,
                         slice_keys=per, hq=hq, hkv=hkv, d=d,
                         q_scale=q_scale, max_abs_err=max_err,
                         past_tolerance=excess, kernel_gap=kernel_gap,
                         nonzero_p_share=nonzero,
                         launches=list(launched), slice=i,
                         stats_ms=stats_ms, stats_plain_ms=stats_plain_ms,
                         stats_bound_ms=stats_bound, stats_bound_by=stats_by,
                         pass2_ms=pass2_ms, pass2_plain_ms=pass2_plain_ms,
                         pass2_bound_ms=pass2_bound, pass2_bound_by=pass2_by,
                         library_ms=None, variant=p.variant,
                         splits=p.splits))
        print(f"19.2 {name} ({b} x {sq} x {hq} q heads over {hkv} KV heads "
              f"of {d}, {skv} e4m3 keys in {n} slices of {per}, {p.variant} "
              f"with {p.splits} splits, round_p): combined max_abs_err "
              f"{max_err:.3g} against the plain version ({excess:.3g} past "
              f"the P-tie allowance, within {FA_TOL}), {kernel_gap:.3g} "
              f"against the unsharded kernel, every slice's result equal, "
              f"nonzero P codes {nonzero:.3g} of the visible keys; "
              f"slice {i}'s stats launch {stats_ms:.4f} ms (plain "
              f"{stats_plain_ms:.4f}, bound {stats_bound:.4f}, {stats_by}), "
              f"pass 2 {pass2_ms:.4f} ms (plain {pass2_plain_ms:.4f}, bound "
              f"{pass2_bound:.4f}, {pass2_by})")
        del q, k, v, ks, vs, stats
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def run_seqshard(torch, dev):
    """Phase 19: the sequence-sharded cache (19.1 two ranks on the card,
    19.2 the slice forms at pod16x16's local shapes)."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        runs = run_seq(torch, dev, Path(tmp))
    t1 = time.perf_counter()
    kernels = check_seq_kernels(torch, dev)
    t2 = time.perf_counter()
    return dict(transport=TP_TRANSPORT, runs=runs, kernels=kernels,
                ranks_s=t1 - t0, kernels_s=t2 - t1, seconds=t2 - t0)


# 20.1: the tensor-parallel split of the SSM and hybrid families on
# TP_RANKS ranks of one model group, both on the one card over gloo (18.1's
# launcher and transport).  RWKV6-1.6B at full width, 4 of its 24 layers
# (32 heads, 16 a rank: each rank's time mix on its heads, its channel
# mix's 3,584 columns, the 65,536-row vocabulary split), and Zamba2-7B at
# full width, 7 of its 81 layers (one group of 6 Mamba2 blocks, the shared
# block and the tail's first block: 56 of 112 Mamba2 heads a rank, the
# in_proj product gathered, the conv on the rank's channels; 16 of the
# shared attention's 32 heads of 112, the MLP's 7,168 columns), each
# trained SSM_TP_STEPS AdamW steps under LightPE-1 and under FP32 in
# float32, and served in float32 (a prefill and decode steps on a float32
# cache: the states over heads, the conv window over channels, the KV
# cache over heads).  Each held to the same run on one rank: the logits
# within SSM_TP_SERVE_TOL, the greedy tokens equal up to each row's first
# near tie; the launches a step and rank exactly the one rank's, every
# leaf equal on the two ranks, step ms and peak memory a rank beside.
#
# The training runs are held against the one-rank run's own spread.  At
# full width RWKV6's gradient is ill-conditioned at a sequence's first
# token: the state is empty there, so a head's output is c v with c the
# scalar sum of r u k, the per-head norm divides it by |c| rms(v), and
# the gradient reaching r, k and u through c grows as 1 / |c|.  A head
# whose c lies near zero makes the gradient norm move with the last bits
# of any sum, on one rank alone (``scripts/torch_rwkv_first_token.py``
# prints each layer's smallest |c| and the gradient's move).  So
# each training task also runs twice more on one rank with the embedding
# scaled by 1 +/- one unit in the last place of its compute type (the
# twins, ``tp_check.train_run``'s ``nudge``), and a step's loss and
# gradient norm are held within the larger of the fixed tolerance
# (TRAIN_LM_RTOL under LightPE-1, SSM_TP_FP32_RTOL under FP32) and
# SSM_TP_FLOOR times the twins' largest relative spread up to that step;
# the params' change within the larger of TP_PARAM_GAP (SSM_TP_FP32_GAP
# under FP32: one sign flip in a leaf's digest) and SSM_TP_FLOOR times
# the twins' change gap.  Where the run is well conditioned (Zamba2-7B,
# RWKV6-1.6B's FP32 first step) the fixed tolerance is the bound.
SSM_TP_STEPS, SSM_TP_BATCH, SSM_TP_SEQ = 2, 2, 256
SSM_TP_TRAIN = [
    dict(name=f"{short}{'_fp32' if fp32 else ''}", kind="train", arch=arch,
         overrides={"n_layers": n, "pe_type": "fp32" if fp32 else "lightpe1",
                    **({"dtype": "float32"} if fp32 else {})},
         batch=SSM_TP_BATCH, seq=SSM_TP_SEQ, steps=SSM_TP_STEPS)
    for short, arch, n in (("rwkv", "rwkv6-1.6b", 4), ("zamba", "zamba2-7b", 7))
    for fp32 in (False, True)]
SSM_TP_SERVE = [
    dict(name=f"{short}_serve", kind="serve", arch=arch,
         overrides={"n_layers": n, "dtype": "float32"}, batch=2, prompt=64,
         steps=4, cache_rows=128, token_seed=20, cache_dtype="float32")
    for short, arch, n in (("rwkv", "rwkv6-1.6b", 4), ("zamba", "zamba2-7b", 7))]
SSM_TP_SERVE_TOL = 1e-3
SSM_TP_FP32_RTOL = 1e-4
SSM_TP_FP32_GAP = 2 / math.sqrt(4096)
SSM_TP_FLOOR = 2.0
# the control: RWKV6's FP32 run with the replicated leaves its mixes use
# for the rank's heads alone taking their gradients unsummed (the CPU
# tests' control, ``tp_check.variant``) must miss the one-rank run by
# the same bounds
SSM_TP_CONTROL = dict(next(t for t in SSM_TP_TRAIN if t["name"] == "rwkv_fp32"),
                      name="rwkv_fp32_control", variant="unsummed_leaves")
# 20.2: the kernels at pod16x16's local shapes of Zamba2-7B's shared
# attention (2 q and 2 KV heads of 112 a rank, float32 q, K, V and P):
# (name, b, sq, skv, hq, hkv, d, start): decode_32k (8 rows a device) and
# prefill_32k's last 4,096 of a rank's 32,768 queries (2 rows a device;
# the costliest rows, the plain version's scores of the whole prompt do
# not fit beside it); the backward at train_4k (a rank's 2 x 4,096 rows
# of a microbatch); fake_quant on a rank's LightPE-1 shards of both
# models' products (one grouped launch)
SSM_TP_SHAPES = [
    ("zamba2-7b decode_32k, a rank", 8, 1, 32768, 2, 2, 112, 32767),
    ("zamba2-7b prefill_32k, a rank's last 4,096 queries", 2, 4096, 32768,
     2, 2, 112, 28672)]
SSM_TP_BWD = ("zamba2-7b train_4k, a rank", 2, 4096, 2, 2, 112)
SSM_TP_SHARDS = [("rwkv tm/wr", (2048, 128)), ("rwkv tm/wo", (128, 2048)),
                 ("rwkv cm/wk", (2048, 448)), ("rwkv cm/wv", (448, 2048)),
                 ("zamba in_proj", (3584, 911)), ("zamba out_proj", (448, 3584)),
                 ("zamba attn/wq", (3584, 224)), ("zamba mlp/w_down",
                                                  (896, 3584))]


def _serve_held(name: str, ranks, one, tol: float) -> dict:
    """Each rank's serving run against one rank's (``one``): the logits
    within ``tol``, the greedy tokens equal up to each row's first step
    whose top-2 margin is below it, the launches equal."""
    import numpy as np
    ref_meta, ref_arr = one
    want = ref_arr["logits"]
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = np.cumprod(top2[..., 1] - top2[..., 0] > tol,
                      axis=0).astype(bool)
    res = {}
    for r, (meta, arr) in enumerate(ranks):
        err = float(np.abs(arr["logits"] - want).max())
        same = bool((arr["greedy"] == np.argmax(want, -1))[sure].all())
        finite = bool(np.isfinite(arr["logits"]).all())
        if err > tol or not same or not finite or not sure.any() \
                or meta["launches"] != ref_meta["launches"]:
            fail(f"{name} rank {r}: max logit err {err} (within {tol}), "
                 f"greedy tokens equal where sure {same} ({int(sure.sum())} "
                 f"compared), finite {finite}; launches {meta['launches']}, "
                 f"one rank's {ref_meta['launches']}")
        res[f"rank{r}"] = dict(max_abs_err=err,
                               tokens_compared=int(sure.sum()),
                               step_ms=meta["step_ms"],
                               peak_gib=meta["peak_gib"],
                               launches=meta["launches"])
    res["one_rank"] = dict(step_ms=ref_meta["step_ms"],
                           peak_gib=ref_meta["peak_gib"],
                           launches=ref_meta["launches"])
    return res


def _ssm_twins(task) -> list:
    """The task's two twins: the embedding scaled by 1 +/- one unit in
    the last place of its compute type (the 20.1 note)."""
    import torch
    from repro_torch import tp_check
    eps = torch.finfo(getattr(torch, tp_check._config(task).dtype)).eps
    return [dict(task, name=f"{task['name']}_twin{i}", nudge=sign * eps)
            for i, sign in enumerate((1.0, -1.0))]


def _ssm_floor(one, twins, base_rtol: float, base_gap: float) -> dict:
    """The bounds a split training run is held to: a step's loss and
    gradient norm within the larger of ``base_rtol`` and SSM_TP_FLOOR
    times the twins' largest relative spread from the one-rank run
    ``one`` up to that step; the params' change within the larger of
    ``base_gap`` and SSM_TP_FLOOR times the twins' change gap."""
    import numpy as np
    from repro_torch import tp_check
    ref_meta, ref_arr = one
    ref = np.asarray(ref_meta["rows"], np.float64)
    spread = np.zeros_like(ref)
    gaps = []
    for meta, arr in twins:
        rows = np.asarray(meta["rows"], np.float64)
        spread = np.maximum(spread, np.abs(rows - ref) / np.abs(ref))
        start, own = _digests(ref_arr, "start"), _digests(arr, "start")
        moved = {k: v - own[k] + start[k]             # from its own start
                 for k, v in _digests(arr, "final").items()}
        gaps.append(tp_check.change_gap(start, moved,
                                        _digests(ref_arr, "final")))
    spread = np.maximum.accumulate(spread, axis=0)
    return dict(rtol=np.maximum(base_rtol, SSM_TP_FLOOR * spread),
                spread=spread.tolist(), twin_gaps=gaps,
                gap=max(base_gap, SSM_TP_FLOOR * max(gaps)))


def _ssm_train_held(meta, arr, one, other, floor) -> dict:
    """A rank's training run against the one-rank run ``one`` within the
    bounds ``floor`` (``_ssm_floor``), as ``_tp_train_held`` holds it."""
    import numpy as np
    h = _tp_train_held(meta, arr, one, other)
    got = np.asarray(meta["rows"], np.float64)
    ref = np.asarray(one[0]["rows"], np.float64)
    rel = (np.abs(got - ref) / np.abs(ref) if got.shape == ref.shape
           else np.full(ref.shape, np.inf))
    h["held"] = dict(ok=bool((rel <= floor["rtol"]).all()),
                     loss_rel=float(rel[:, 0].max()),
                     gnorm_rel=float(rel[:, 1].max()),
                     rel=rel.tolist(), rtol=floor["rtol"].tolist())
    return h


def run_ssm_tp(torch, dev, tmp: Path):
    """Phase 20.1 (the SSM_TP_TRAIN / SSM_TP_SERVE note)."""
    from repro_torch import tp_check

    print(f"20.1 transport: {TP_TRANSPORT}, {TP_RANKS} ranks of a (1, "
          f"{TP_RANKS}) ('data', 'model') mesh on {card_line()}")
    tasks = SSM_TP_TRAIN + SSM_TP_SERVE
    twins = {t["name"]: _ssm_twins(t) for t in SSM_TP_TRAIN}
    one = {}
    for task in tasks + [w for ws in twins.values() for w in ws]:
        one[task["name"]] = tp_check.run_task(task, dev, None)
        gc.collect()
        torch.cuda.empty_cache()
    ranks = _tp_ranks(tmp, tasks + [SSM_TP_CONTROL])
    res = {}
    for task in SSM_TP_TRAIN:
        name = task["name"]
        base = one[name]
        (m0, a0), (m1, a1) = ranks[name]
        fp32 = name.endswith("_fp32")
        floor = _ssm_floor(base, [one[w["name"]] for w in twins[name]],
                           SSM_TP_FP32_RTOL if fp32 else TRAIN_LM_RTOL,
                           SSM_TP_FP32_GAP if fp32 else TP_PARAM_GAP)
        for r, (meta, arr, other) in enumerate(((m0, a0, a1),
                                                (m1, a1, a0))):
            h = _ssm_train_held(meta, arr, base, other, floor)
            if not (h["held"]["ok"] and h["param_gap"] <= floor["gap"]
                    and not h["ranks_differ"] and h["finite"]
                    and h["launches_equal"]):
                fail(f"20.1 {name} rank {r}: steps {meta['rows']} against "
                     f"one rank's {base[0]['rows']}: {h['held']} (the "
                     f"twins' spread {floor['spread']}, their rows "
                     f"{[one[w['name']][0]['rows'] for w in twins[name]]}); "
                     f"params' change gap {h['param_gap']} (within "
                     f"{floor['gap']}, the twins' {floor['twin_gaps']}); "
                     f"leaves differing between the ranks "
                     f"{h['ranks_differ']}; launches a step "
                     f"{meta['launches']}, one rank's {base[0]['launches']}")
            res[f"{name}_rank{r}"] = dict(
                rows=meta["rows"], param_gap=h["param_gap"],
                step_ms=meta["step_ms"], peak_gib=meta["peak_gib"],
                launches_per_step=meta["launches"][-1], **h["held"])
        res[f"{name}_one_rank"] = dict(
            rows=base[0]["rows"], step_ms=base[0]["step_ms"],
            peak_gib=base[0]["peak_gib"],
            launches_per_step=base[0]["launches"][-1])
        res[f"{name}_twins"] = dict(
            nudge=[w["nudge"] for w in twins[name]],
            rows=[one[w["name"]][0]["rows"] for w in twins[name]],
            spread=floor["spread"], gaps=floor["twin_gaps"])
        t = res[f"{name}_rank0"]
        print(f"20.1 {name} {task['arch']} ({task['overrides']}, "
              f"{task['batch']} x {task['seq']}, AdamW, {task['steps']} "
              f"steps) on (1, {TP_RANKS}): rank 0 "
              f"{[[round(x, 5) for x in row] for row in t['rows']]}, one "
              f"rank {[[round(x, 5) for x in row] for row in base[0]['rows']]}"
              f", its twins (embedding x 1 +/- {twins[name][0]['nudge']:.3g}) "
              f"{[[[round(x, 5) for x in row] for row in one[w['name']][0]['rows']] for w in twins[name]]}"
              f": loss / grad norm rel a step "
              f"{[[float(f'{x:.3g}') for x in row] for row in t['rel']]} "
              f"(within {[[float(f'{x:.3g}') for x in row] for row in t['rtol']]}"
              f"); params' change gap {t['param_gap']:.4g} (within "
              f"{floor['gap']:.4g}; the twins' "
              f"{[round(g, 4) for g in floor['twin_gaps']]}); every leaf "
              f"equal on the ranks; step ms a rank "
              f"{[round(x, 1) for x in t['step_ms']]} (one rank "
              f"{[round(x, 1) for x in base[0]['step_ms']]}); peak "
              f"{t['peak_gib']:.2f} GiB a rank (one rank "
              f"{base[0]['peak_gib']:.2f}); launches a step and rank "
              f"{t['launches_per_step']} (one rank's: equal)")
        if name == "rwkv_fp32":
            (c0, ca0), (_, ca1) = ranks[SSM_TP_CONTROL["name"]]
            c = _ssm_train_held(c0, ca0, base, ca1, floor)
            if c["held"]["ok"] and c["param_gap"] <= floor["gap"]:
                fail(f"20.1 control ({SSM_TP_CONTROL['variant']}) held to "
                     f"one rank: steps {c0['rows']}, {c['held']}, params' "
                     f"change gap {c['param_gap']} (within {floor['gap']})")
            res["control"] = dict(variant=SSM_TP_CONTROL["variant"],
                                  rows=c0["rows"], rel=c["held"]["rel"],
                                  param_gap=c["param_gap"])
            print(f"20.1 control {name} ({SSM_TP_CONTROL['variant']}): "
                  f"loss / grad norm rel a step "
                  f"{[[float(f'{x:.3g}') for x in row] for row in c['held']['rel']]}"
                  f", params' change gap {c['param_gap']:.4g}: misses the "
                  f"bounds (as it must)")
    for task in SSM_TP_SERVE:
        name = task["name"]
        held = _serve_held(f"20.1 {name}", ranks[name], one[name],
                           SSM_TP_SERVE_TOL)
        res[name] = held
        s_, o_ = held["rank0"], held["one_rank"]
        print(f"20.1 {name} {task['arch']} ({task['overrides']}, batch "
              f"{task['batch']}, {task['prompt']} + {task['steps']} tokens, "
              f"float32, a float32 cache) on (1, {TP_RANKS}): max logit err "
              f"against "
              f"one rank {s_['max_abs_err']:.4g} (within {SSM_TP_SERVE_TOL}), "
              f"greedy tokens equal ({s_['tokens_compared']} row steps "
              f"before a near tie); step ms a rank "
              f"{[round(x, 2) for x in s_['step_ms']]} (one rank "
              f"{[round(x, 2) for x in o_['step_ms']]}); peak "
              f"{s_['peak_gib']:.2f} GiB a rank (one rank "
              f"{o_['peak_gib']:.2f}); launches a rank {s_['launches']} (one "
              f"rank's: equal)")
    return res


def check_ssm_tp_kernels(torch, dev):
    """Phase 20.2: ``flash_attention``'s forward at SSM_TP_SHAPES and its
    backward at SSM_TP_BWD (float32, P not rounded: the unified
    attention's) against the plain versions within ``FA_TOL`` / phase
    10.1's tolerances, two calls bitwise equal, timed beside the plain
    version, SDPA and the bound; ``fake_quant`` on SSM_TP_SHARDS under
    LightPE-1 (one grouped launch) against its plain version, 0 elements
    differing, timed."""
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import (attention_backward,
                                                     flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention import plan as fa_plan
    from repro_torch.kernels.flash_attention.ref import (
        ref_attention_gqa, ref_attention_gqa_bwd)
    from repro_torch.quant import fake_quant as quant_fq
    from repro_torch.quant.qconfig import preset
    from repro_torch.train_check import attention_grad_errors

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(20)
    rows = []
    for name, b, sq, skv, hq, hkv, d, start in SSM_TP_SHAPES:
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device=dev)
                   for n, h in ((sq, hq), (skv, hkv), (skv, hkv)))
        st = torch.full((b,), start, dtype=torch.int32, device=dev)

        def kernel():
            return flash_attention_gqa(q, k, v, st)

        def plain():
            return ref_attention_gqa(q, k, v, st)

        before = flash_attention.launches
        got, again = kernel(), kernel()
        launches = flash_attention.launches - before
        want = plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if launches != 2 or not torch.equal(got, again) \
                or not bool(torch.isfinite(got).all()) or err > FA_TOL:
            fail(f"20.2 flash_attention {name}: max_abs_err {err} "
                 f"(tolerance {FA_TOL}), {launches} launches for 2 calls, "
                 f"bitwise repeat {torch.equal(got, again)}")
        del got, again, want
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain, reps=3, warmup=1)
        tq, tk, tv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        # query i of the cut sits at start + i and sees keys 0 .. that
        mask = (torch.arange(skv, device=dev)[None]
                <= start + torch.arange(sq, device=dev)[:, None])
        library_ms = time_ms(torch, lambda: sdpa(tq, tk, tv, attn_mask=mask))
        del tq, tk, tv, mask
        bound, by, nbytes, _ = attention_bound(
            b, hq, hkv, d, [(0, start + i + 1) for i in range(sq)], False)
        p = fa_plan(b, sq, skv, hq, hkv, d, False)
        rows.append(dict(name=name, b=b, sq=sq, skv=skv, hq=hq, hkv=hkv,
                         d=d, start=start, max_abs_err=err,
                         launches=launches, bitwise_repeat=True, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound, bound_by=by, bytes=nbytes,
                         variant=p.variant, splits=p.splits))
        print(f"20.2 flash_attention {name} ({b} x {sq} x {hq} q heads over "
              f"{hkv} KV heads of {d}, {skv} float32 keys, float32 q, "
              f"{p.variant}, {p.splits} splits): max_abs_err {err:.3g} "
              f"(within {FA_TOL}), two calls bitwise equal; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"{library_ms:.4f} ms, bound {bound:.4f} ms ({by})")
        del q, k, v
        gc.collect()
        torch.cuda.empty_cache()

    name, b, s, hq, hkv, d = SSM_TP_BWD
    q, k, v, dout = (torch.randn((b, s, h, d), generator=gen, device=dev)
                     for h in (hq, hkv, hkv, hq))
    st = torch.zeros(b, dtype=torch.int32, device=dev)

    def kernel_bwd():
        return attention_backward(q, k, v, st, dout)

    before = flash_attention.backward_launches
    got, again = kernel_bwd(), kernel_bwd()
    launches = flash_attention.backward_launches - before
    want = ref_attention_gqa_bwd(q, k, v, st, dout)
    held = attention_grad_errors(got, want, dout)
    if launches != 2 or not held["ok"] or not all(
            torch.equal(a, c) for a, c in zip(got, again)):
        fail(f"20.2 backward {name}: {held}, {launches} launches for 2")
    del got, again, want
    ms = time_ms(torch, kernel_bwd)
    plain_ms = time_ms(torch, lambda: ref_attention_gqa_bwd(
        q, k, v, st, dout), reps=3, warmup=1)
    tq, tk, tv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    tdo = dout.transpose(1, 2).contiguous()
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa(tq, tk, tv, is_causal=True), (tq, tk, tv), tdo))
    pairs = b * hq * s * (s + 1) // 2
    nbytes = 4 * (2 * q.numel() + 2 * dout.numel() + 4 * b * s * hkv * d)
    bound, by = bound_ms(nbytes, 2.0 * d * pairs
                         * bwd_part_products(False, False), H100_BF16_FLOPS)
    bwd = dict(name=name, b=b, s=s, hq=hq, hkv=hkv, d=d,
               max_abs_err=held["max_abs_err"], launches=launches, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library="SDPA forward and backward through autograd "
                       "(float32, is_causal)", bound_ms=bound, bound_by=by)
    print(f"20.2 flash_attention backward {name} ({b} x {s}, {hq} q heads "
          f"over {hkv} KV heads of {d}, float32): max_abs_err "
          f"{held['max_abs_err']:.3g} within phase 10.1's tolerances, two "
          f"calls bitwise equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, SDPA forward + backward {library_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by})")
    del q, k, v, dout, tq, tk, tv, tdo
    gc.collect()
    torch.cuda.empty_cache()

    qcfg = preset("lightpe1")
    ws = [torch.randn(shape, generator=gen, device=dev) / math.sqrt(shape[0])
          for _, shape in SSM_TP_SHARDS]

    def fq():
        return quant_fq.fake_quant_weights(ws, qcfg)

    def fq_plain():
        with plain_kernels(torch):
            return quant_fq.fake_quant_weights(ws, qcfg)

    before = fake_quant.launches
    got = fq()
    fq_launches = fake_quant.launches - before
    want = fq_plain()
    differing = sum(int((a != c).sum()) for a, c in zip(got, want))
    fq_err = max(float((a - c).abs().max()) for a, c in zip(got, want))
    if differing or fq_launches != 1:
        fail(f"20.2 fake_quant on a rank's shards: {differing} elements "
             f"differ from the plain version, {fq_launches} launches for 1")
    fq_ms = time_ms(torch, fq)
    fq_plain_ms = time_ms(torch, fq_plain, reps=3, warmup=1)
    n = sum(w.numel() for w in ws)
    fq_bound, fq_by = bound_ms(sum(w.numel() * 8 + w.shape[1] * 4
                                   for w in ws), 5 * n)
    shards = dict(shapes=[[nm, list(sh)] for nm, sh in SSM_TP_SHARDS],
                  elements=n, differing=differing, max_abs_err=fq_err,
                  launches=fq_launches, ms=fq_ms, plain_ms=fq_plain_ms,
                  bound_ms=fq_bound, bound_by=fq_by, library_ms=None)
    print(f"20.2 fake_quant on a rank's LightPE-1 shards of RWKV6-1.6B and "
          f"Zamba2-7B at 16 ({len(ws)} weights, {n} elements, one grouped "
          f"launch): {differing} elements differing from the plain "
          f"version; kernel {fq_ms:.4f} ms, plain {fq_plain_ms:.4f} ms, "
          f"bound {fq_bound:.4f} ms ({fq_by})")
    del ws, got, want
    return rows, bwd, shards


def run_ssm_split(torch, dev):
    """Phase 20: the tensor-parallel split of the SSM and hybrid families
    (20.1 two ranks of one model group on the card, 20.2 the kernels at
    pod16x16's local shapes)."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        runs = run_ssm_tp(torch, dev, Path(tmp))
    t1 = time.perf_counter()
    kernels, bwd, shards = check_ssm_tp_kernels(torch, dev)
    t2 = time.perf_counter()
    return dict(transport=TP_TRANSPORT, runs=runs, kernels=kernels,
                backward=bwd, fake_quant=shards, ranks_s=t1 - t0,
                kernels_s=t2 - t1, seconds=t2 - t0)


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)  # progress survives a kill
    t_start = time.perf_counter()
    # flex_attention's compiled kernels (a library call timed in 11.1 and
    # 16.1) are built inside the checkout, in this process
    for var, val in (("TORCHINDUCTOR_CACHE_DIR", ROOT / "build" / "inductor"),
                     ("TRITON_CACHE_DIR", ROOT / "build" / "triton"),
                     ("TORCHINDUCTOR_COMPILE_THREADS", 1)):
        os.environ.setdefault(var, str(val))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir() or not REF.exists() \
            or not SERVE_REF.exists() or not COEX_REF.exists() \
            or not SCALE_REF.exists() or not TRAIN_REF.exists() \
            or not GEMMA_REF.exists() or not MOE_REF.exists() \
            or not VARIANTS_REF.exists() or not SSM_REF.exists() \
            or not DRYRUN_REF.exists() or not FAMILY_REF.exists() \
            or not FP8_REF.exists():
        fail("src/repro_torch or the JAX reference results are missing "
             "beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))

    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    import tempfile
    dry_tmp = tempfile.TemporaryDirectory()
    workers = start_dryrun(Path(dry_tmp.name))
    try:
        return _phases(torch, t_start, workers)
    finally:
        for p in workers[0]:
            if p.poll() is None:
                p.kill()
                p.wait()
        dry_tmp.cleanup()


def _phases(torch, t_start, workers) -> int:
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    # every nvcc starts now, one a source (fake_quant and quant_matmul
    # first); phases 3, 4, 8 and 9's walks launch fake_quant or no kernel,
    # so they run while the others build (their host times share the
    # cores with the compilers and the dry run's niced workers)
    t0 = time.perf_counter()
    _build.start()
    built = _build.wait(("fake_quant",))
    t3 = time.perf_counter()
    modes = check_kernels(torch, dev)
    model_shapes = check_model_shapes(torch, dev)
    launches, surrogate = run_slice(torch, dev)
    print(f"phases 3-4 (fake_quant, the quickstart slice; beside the "
          f"build): {time.perf_counter() - t3:.2f} s")
    t8 = time.perf_counter()
    coex, fronts = run_coexplore(torch, dev, surrogate)
    print(f"phase 8 (co-exploration; beside the build): "
          f"{time.perf_counter() - t8:.2f} s")
    t9 = time.perf_counter()
    scale = run_scale(torch, dev, fronts)
    walks_s = time.perf_counter() - t9
    built.update(_build.wait())
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(built)} "
          f"(phases 3, 4, 8 and 9.1-9.5 beside it)")
    for name, (secs, output) in built.items():
        print(f"  {name}: {secs:.2f} s; ptxas: {ptxas_summary(output)}")

    # 15.3's workers ran beside the build; no later timed phase shares the
    # host
    pause_dryrun(workers, go=False)
    t5 = time.perf_counter()
    qmm_err, fa_err, qmm_cast = check_serving_kernels(torch, dev)
    serve_launches, qmm, fa, serving = run_serving(torch, dev)
    qat = run_qat_serving(torch, dev)
    print(f"phases 5-7 (serving): {time.perf_counter() - t5:.2f} s")
    t9 = time.perf_counter()
    scale["serving_telemetry"] = serve_with_telemetry(torch, dev)
    print(f"phase 9 (DSE at scale: 9.1-9.5 {walks_s:.2f} s beside the "
          f"build, 9.6 {time.perf_counter() - t9:.2f} s)")
    t10 = time.perf_counter()
    prefetch_draws()         # 11.2-13.3's numpy weights, beside phase 10 on
    training = run_training(torch, dev)
    print(f"phase 10 (training): {time.perf_counter() - t10:.2f} s")
    t11 = time.perf_counter()
    windowed = check_window_kernel(torch, dev)
    gemma, gemma_packs, gemma_records = run_gemma(torch, dev)
    moe, moe_params = run_moe(torch, dev)
    print(f"phase 11 (decoder family): {time.perf_counter() - t11:.2f} s")
    t12 = time.perf_counter()
    variants = run_variants(torch, dev, gemma_packs, gemma_records)
    print(f"phase 12 (attention paths: perf variants, mixed precision, "
          f"whisper): {time.perf_counter() - t12:.2f} s")
    t13 = time.perf_counter()
    ssm = run_ssm(torch, dev)
    print(f"phase 13 (SSM and hybrid families): "
          f"{time.perf_counter() - t13:.2f} s")
    ssm_names = ("rwkv6-1.6b", "zamba2-7b")
    t14 = time.perf_counter()
    launch = run_launch(torch, dev, moe_params)
    del moe_params
    gc.collect()
    print(f"phase 14 (the launch layer): {time.perf_counter() - t14:.2f} s")
    t15 = time.perf_counter()
    dryrun = run_dryrun(torch, dev, workers)
    dryrun["seconds"] = time.perf_counter() - t15
    print(f"phase 15 (the dry run): {dryrun['seconds']:.2f} s")
    families = run_families(torch, dev)
    print(f"phase 16 (every family trains: 16.1 "
          f"{families['backward_s']:.2f} s, 16.2-16.3 "
          f"{families['train_s']:.2f} s, 16.4 "
          f"{families['reference_s']:.2f} s): {families['seconds']:.2f} s")
    fp8 = run_fp8(torch, dev)
    print(f"phase 17 (the fp8 K/V cache: 17.1 {fp8['kernels_s']:.2f} s, 17.2 "
          f"{fp8['serve_s']:.2f} s): {fp8['seconds']:.2f} s")
    split = run_split(torch, dev)
    print(f"phase 18 (the tensor-parallel split: 18.1 "
          f"{split['ranks_s']:.2f} s, 18.2 {split['kernels_s']:.2f} s): "
          f"{split['seconds']:.2f} s")
    seq = run_seqshard(torch, dev)
    print(f"phase 19 (the sequence-sharded cache: 19.1 "
          f"{seq['ranks_s']:.2f} s, 19.2 {seq['kernels_s']:.2f} s): "
          f"{seq['seconds']:.2f} s")
    ssm_split = run_ssm_split(torch, dev)
    print(f"phase 20 (the split of the SSM and hybrid families: 20.1 "
          f"{ssm_split['ranks_s']:.2f} s, 20.2 "
          f"{ssm_split['kernels_s']:.2f} s): {ssm_split['seconds']:.2f} s")

    # the row's main numbers: one grouped launch over the 15 VGG-16
    # weights, affine-8, float32; the bfloat16 and per-weight times beside
    main, bf16 = modes[("float32", "affine", 8)], modes[("bfloat16", "affine", 8)]
    kernels = [dict(
        name="fake_quant", route="cuda",
        source="src/repro_torch/csrc/fake_quant.cu",
        replaces="src/repro/kernels/fake_quant/fake_quant.py:45",
        launches=launches, max_abs_err=max(m["max_abs_err"]
                                           for m in modes.values()),
        differing=sum(m["differing"] for m in modes.values()),
        ms=main["ms"], per_weight_ms=main["per_weight_ms"],
        cold_ms=main["cold_ms"], bf16_ms=bf16["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_bf16_ms=bf16["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"],
        unit="15 VGG-16/CIFAR-10 weights, one grouped launch",
        smollm_elements_compared=model_shapes,
        qat_serving_launches={k: r["fake_quant_launches"]
                              for k, r in qat.items() if k != "control"},
        moe_experts=moe["expert_fake_quant"],
        moe_serving_launches={k: r["launches"]["fake_quant"]
                              for k, r in moe["runs"].items()},
        variant_training_launches={
            k: r["launches"]["fake_quant"]
            for k, r in variants["flash"]["train"].items()},
        launch_train_per_step=launch["train_cli"]["per_step"]["fake_quant"],
        ssm_launches={name: {
            "cut_per_step": ssm[name]["cut"]["per_step"]["fake_quant"],
            "full_per_step": ssm[name]["full"]["per_step"]["fake_quant"],
            "cut_runs": {k: r["launches"]["fake_quant"] for k, r in
                         ssm[name]["cut"]["runs"].items()},
            "full_runs": {k: r["launches"]["fake_quant"] for k, r in
                          ssm[name]["full"]["modes"].items()}}
            for name in ssm_names},
        modes=list(modes.values()))]
    # the rows' main numbers are one decode step's (11 of the 12 steps);
    # the prefill step's stand beside them
    for name, rows, err, replaces, library in (
            ("quant_matmul", qmm, qmm_err,
             "src/repro/kernels/quant_matmul/quant_matmul.py:106",
             "torch.matmul on the dequantized float32 weights (no single "
             "call computes the packed product)"),
            ("flash_attention", fa, fa_err,
             "src/repro/kernels/flash_attention/flash_attention.py:71",
             "scaled_dot_product_attention with the same mask, enable_gqa")):
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=replaces, launches=serve_launches[name],
            max_abs_err=err, ms=rows["decode"]["ms"],
            plain_ms=rows["decode"]["plain_ms"],
            bound_ms=rows["decode"]["bound_ms"],
            bound_by=rows["decode"]["bound_by"],
            library_ms=rows["decode"]["library_ms"], library=library,
            unit="one decode step of SmolLM-135M, 4 slots, LightPE-1",
            prefill=rows["prefill"]))
        if name == "flash_attention":
            kernels[-1].update(variant={p: r["variant"] for p, r in
                                        rows.items() if p != "bf16_q"},
                               bound_f32_ms=rows["decode"]["bound_f32_ms"],
                               bf16_q=rows["bf16_q"], windowed=windowed,
                               gemma_launches=gemma["runs"]["lightpe1"][
                                   "launches"]["flash_attention"],
                               variants=variants["kernels"],
                               variant_launches=dict(
                                   block_local=variants["block_local"][
                                       "full"]["launches"]["flash_attention"],
                                   kv_replicated=variants["kv_replicated"][
                                       "runs"]["lightpe1"]["launches"][
                                       "flash_attention"],
                                   flash_forward=variants["flash"]["forward"][
                                       "float32"]["launches"],
                                   whisper_prefill=variants["whisper"]["full"][
                                       "prefill_launches"]["flash_attention"],
                                   whisper_decode=variants["whisper"]["full"][
                                       "decode_launches"]["flash_attention"]),
                               head_dim_112=ssm["kernel_112"],
                               launch_per_step=dict(
                                   train=launch["train_cli"]["per_step"][
                                       "flash_attention"],
                                   mesh_train=launch["mesh"]["per_step"][
                                       "flash_attention"],
                                   serve_gemma=launch["serve_cli"][
                                       "per_step"],
                                   moe_ep=launch["moe_ep"]["per_step"]),
                               zamba_launches=dict(
                                   cut_per_step=ssm["zamba2-7b"]["cut"][
                                       "per_step"]["flash_attention"],
                                   full_per_step=ssm["zamba2-7b"]["full"][
                                       "per_step"]["flash_attention"],
                                   full_runs={k: r["launches"][
                                       "flash_attention"] for k, r in
                                       ssm["zamba2-7b"]["full"][
                                           "modes"].items()},
                                   reduced_packed_per_step=ssm["packed"][
                                       "zamba2-7b"][
                                       "flash_attention_per_step"]))
        if name == "quant_matmul":
            kernels[-1].update(
                variant={p: r["variant"] for p, r in rows.items()},
                bound_f32_ms=rows["decode"]["bound_f32_ms"],
                per_projection_ms=rows["decode"]["per_projection_ms"],
                variant_launches=dict(
                    block_local=variants["block_local"]["full"]["launches"][
                        "quant_matmul"],
                    whisper_prefill=variants["whisper"]["full"][
                        "prefill_launches"]["quant_matmul"],
                    whisper_decode=variants["whisper"]["full"][
                        "decode_launches"]["quant_matmul"]),
                cast=qmm_cast,
                ssm_packed_launches={
                    name: {k: r["launches"]["quant_matmul"] for k, r in
                           ssm["packed"][name]["runs"].items()}
                    for name in ssm_names})
    bwd = training["backward"]
    main_bwd = bwd["train_f32"]
    kernels.append(dict(
        name="flash_attention_backward", route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:71",
        launches=training["train"]["launches"]["flash_attention_backward"],
        max_abs_err=max(r["max_abs_err"] for r in bwd.values()),
        ms=main_bwd["ms"], plain_ms=main_bwd["plain_ms"],
        bound_ms=main_bwd["bound_ms"], bound_by=main_bwd["bound_by"],
        library_ms=main_bwd["library_ms"],
        bound_share=main_bwd["bound_share"],
        bound_plain_ms=main_bwd["bound_plain_ms"],
        issued_ms=main_bwd["issued_ms"], tflops=main_bwd["tflops"],
        tc_tflops=main_bwd["tc_tflops"],
        library="the backward of scaled_dot_product_attention(is_causal="
                "True, enable_gqa=True) through autograd",
        unit="one layer of SmolLM-135M training, 16 x 256 tokens, float32 "
             "q, k, v (the gradient of the Pallas kernel's function; the "
             "Pallas kernel has no backward)",
        fwd_bwd_ms=main_bwd["fwd_bwd_ms"], shapes=bwd,
        variant_training_launches={
            k: r["launches"]["backward"]
            for k, r in variants["flash"]["train"].items()},
        launch_train_per_step=launch["train_cli"]["per_step"][
            "flash_attention_backward"],
        families=families["backward"],
        family_training_launches={
            arch: r["launches"]["flash_attention_backward"]
            for arch, r in families["train"].items()}))
    # the wgmma kernels: the forward's prefill at head_dims 112 /
    # 128 (float32 q) and 256, the backward at 112 / 128 / 256; launches
    # from 16.2-16.3's training runs (the path that runs both), the main
    # numbers Gemma-3-1B's (11.1's prefill with a float32 q, 16.1's global
    # layer in float32: the QAT model's types)
    fwd_rows = [r for r in windowed + variants["kernels"] + ssm["kernel_112"]
                if r["variant"] == "wgmma"]
    main_fwd = next(r for r in windowed if r["name"] == "gemma3-1b prefill"
                    and r["q_type"] == "float32")
    wide_bwd = {k: r for k, r in families["backward"].items()
                if r["variant"] == "wgmma"}
    main_wbwd = wide_bwd["gemma3_global_f32"]
    train_runs = families["train"].values()
    kernels.append(dict(
        name="flash_attention_wgmma", route="cuda",
        source="src/repro_torch/csrc/flash_attention_wgmma.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:71",
        launches=sum(r["launches"]["flash_attention_wgmma"]
                     for r in train_runs),
        max_abs_err=max(r["max_abs_err"] for r in fwd_rows),
        ms=main_fwd["ms"], plain_ms=main_fwd["plain_ms"],
        bound_ms=main_fwd["bound_ms"], bound_by=main_fwd["bound_by"],
        library_ms=main_fwd["library_ms"], library=main_fwd["library"],
        unit="Gemma-3-1B's prefill, 4 x 900 rows, 4/1 heads of 256, "
             "window 512, float32 q on the float32 cache",
        shapes=fwd_rows))
    kernels.append(dict(
        name="flash_attention_backward_wgmma", route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:71",
        launches=sum(r["launches"]["flash_attention_backward_wgmma"]
                     for r in train_runs),
        max_abs_err=max(r["max_abs_err"] for r in wide_bwd.values()),
        ms=main_wbwd["ms"], plain_ms=main_wbwd["plain_ms"],
        bound_ms=main_wbwd["bound_ms"], bound_by=main_wbwd["bound_by"],
        library_ms=main_wbwd["library_ms"], library=main_wbwd["library"],
        unit="one Gemma-3-1B global layer's gradient, 2 x 1024 tokens, 4/1 "
             "heads of 256, float32 (the QAT model's types)",
        shapes=wide_bwd))
    # the split and mma kernels on e4m3 K and V
    # (csrc/flash_attention_fp8.cu): launches from 17.2's runs (every
    # decode step's; the prefills ran the wgmma kernel on the same cache,
    # counted beside), the main numbers decode_32k's on peaked logits
    # (17.1), SDPA on the bfloat16 cache beside it (not the same function)
    main_fp8 = next(r for r in fp8["kernels"] if r["name"]
                    == "decode_32k peaked" and r["q_type"] == "float32")
    fp8_runs = [fp8["reference"]["launches"]] + [
        r["launches"] for r in fp8["variants"].values()]
    kernels.append(dict(
        name="flash_attention_fp8", route="cuda",
        source="src/repro_torch/csrc/flash_attention_fp8.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:71",
        launches=sum(r["fp8"] for r in fp8_runs),
        wgmma_launches=sum(r["wgmma"] for r in fp8_runs),
        max_abs_err=max(r["max_abs_err"] for r in fp8["kernels"]),
        past_tolerance=max(r["past_tolerance"] for r in fp8["kernels"]),
        ms=main_fp8["ms"], plain_ms=main_fp8["plain_ms"],
        bound_ms=main_fp8["bound_ms"], bound_by=main_fp8["bound_by"],
        library_ms=None,
        library="none computes it (P rounded to e4m3); "
                "sdpa_bf16_cache_ms: SDPA on the cache upcast to bfloat16, "
                "not the same function",
        sdpa_bf16_cache_ms=fp8["decode_32k"]["sdpa_bf16_cache_ms"],
        bf16_cache_ms=fp8["decode_32k"]["bf16_cache_ms"],
        bf16_cache_bound_ms=fp8["decode_32k"]["bf16_cache_bound_ms"],
        unit="Qwen3-32B decode_32k v3's attention: 8 x 1 x 64 heads, 16 "
             "replicated KV heads of 128, 32,768 e4m3 keys, float32 q, "
             "round_p",
        shapes=fp8["kernels"]))
    # the split's kernels at a rank's local shapes (18.2), and the
    # launches a rank made on 18.1's split runs
    tp_main = split["kernels"][0]
    tp_runs = split["runs"]
    tp_launches = {k: v * TP_TRAIN["steps"] for k, v in
                   tp_runs["train_rank0"]["launches_per_step"].items()}
    for k, v in tp_runs["serve_rank0"]["launches"].items():
        tp_launches[k] = tp_launches.get(k, 0) + v
    kernels.append(dict(
        name="flash_attention_tp", route="cuda",
        source="src/repro_torch/csrc/flash_attention_fp8.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:71",
        launches=tp_launches["flash_attention"],
        max_abs_err=max(r["max_abs_err"] for r in split["kernels"]),
        past_tolerance=max(r["past_tolerance"] for r in split["kernels"]),
        ms=tp_main["ms"], plain_ms=tp_main["plain_ms"],
        bound_ms=tp_main["bound_ms"], bound_by=tp_main["bound_by"],
        library_ms=None,
        library="none computes it (P rounded to e4m3)",
        unit="Qwen3-32B decode_32k at pod16x16, one rank: 8 x 1 x 4 q heads "
             "over one of 8 e4m3 KV heads read as a strided view, 32,768 "
             "keys, float32 q, round_p",
        rank_launches_18_1=tp_launches,
        shapes=split["kernels"], backward=split["backward"]))
    # the slice forms (19): launches a rank made on 19.1's runs, the main
    # numbers one slice's of Qwen3-32B's decode_32k at pod16x16 (19.2)
    seq_launches = {}
    for task in SEQ_TASKS:
        for k, v in seq["runs"][f"{task['name']}_rank0"]["launches"].items():
            seq_launches[k] = seq_launches.get(k, 0) + v
    seq_main = seq["kernels"][0]
    for form, source in (("stats", "flash_attention_fwd.cuh"),
                         ("pass2", "flash_attention_fwd.cuh")):
        kernels.append(dict(
            name=f"flash_attention_{form}", route="cuda",
            source=f"src/repro_torch/csrc/{source}",
            replaces="src/repro/kernels/flash_attention/flash_attention.py:71",
            launches=seq_launches[f"flash_attention_{form}"],
            max_abs_err=max(r["max_abs_err"] for r in seq["kernels"]),
            past_tolerance=max(r["past_tolerance"] for r in seq["kernels"]),
            ms=seq_main[f"{form}_ms"], plain_ms=seq_main[f"{form}_plain_ms"],
            bound_ms=seq_main[f"{form}_bound_ms"],
            bound_by=seq_main[f"{form}_bound_by"], library_ms=None,
            library="none computes it (a slice's (M, L), or P rounded to "
                    "e4m3 under a group's (M, L))",
            unit=f"one slice of Qwen3-32B v1b_f8_cache_seqshard decode_32k "
                 f"at pod16x16: 8 x 1 x 64 q heads over 8 e4m3 KV heads of "
                 f"128, 2,048 of 32,768 keys, float32 q, round_p "
                 f"({seq_main['variant']} kernel)",
            rank_launches_19_1=seq_launches, shapes=seq["kernels"]))
    # the SSM and hybrid split (20): launches a rank made on 20.1's
    # runs, the main numbers Zamba2-7B's decode_32k attention at a
    # pod16x16 rank (20.2)
    ssm_runs = ssm_split["runs"]
    ssm_launches = {}
    for task in SSM_TP_TRAIN:
        for k, v in ssm_runs[f"{task['name']}_rank0"][
                "launches_per_step"].items():
            ssm_launches[k] = ssm_launches.get(k, 0) + v * task["steps"]
    for task in SSM_TP_SERVE:
        for k, v in ssm_runs[task["name"]]["rank0"]["launches"].items():
            ssm_launches[k] = ssm_launches.get(k, 0) + v
    ssm_main = ssm_split["kernels"][0]
    kernels.append(dict(
        name="flash_attention_ssm_tp", route="cuda",
        source="src/repro_torch/csrc/flash_attention_fwd.cuh",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:71",
        launches=ssm_launches["flash_attention"],
        max_abs_err=max(r["max_abs_err"] for r in ssm_split["kernels"]),
        ms=ssm_main["ms"], plain_ms=ssm_main["plain_ms"],
        bound_ms=ssm_main["bound_ms"], bound_by=ssm_main["bound_by"],
        library_ms=ssm_main["library_ms"],
        library="SDPA (float32, the causal rows as a mask)",
        unit="Zamba2-7B decode_32k at pod16x16, one rank: 8 x 1 x 2 q heads "
             "over 2 KV heads of 112, 32,768 float32 keys, float32 q and P",
        rank_launches_20_1=ssm_launches, shapes=ssm_split["kernels"],
        backward=ssm_split["backward"]))
    fq_shards = ssm_split["fake_quant"]
    kernels.append(dict(
        name="fake_quant_ssm_tp", route="cuda",
        source="src/repro_torch/csrc/fake_quant.cu",
        replaces="src/repro/kernels/fake_quant/fake_quant.py:45",
        launches=ssm_launches["fake_quant"],
        max_abs_err=fq_shards["max_abs_err"],
        differing=fq_shards["differing"], ms=fq_shards["ms"],
        plain_ms=fq_shards["plain_ms"], bound_ms=fq_shards["bound_ms"],
        bound_by=fq_shards["bound_by"], library_ms=None,
        library="none computes LightPE-1's pow2 weight codes",
        unit="a pod16x16 rank's LightPE-1 shards of RWKV6-1.6B and "
             "Zamba2-7B's products, one grouped launch",
        shards=fq_shards["shapes"]))
    print(f"smoke: {time.perf_counter() - t_start:.2f} s, the build "
          f"included")
    print(json.dumps({"kernels": kernels, "serving": serving, "qat": qat,
                      "coexplore": coex, "scale": scale,
                      "decoder": {"gemma": gemma, "moe": moe},
                      "variants": {k: v for k, v in variants.items()
                                   if k != "kernels"},
                      "ssm": {k: v for k, v in ssm.items()
                              if k != "kernel_112"},
                      "launch": launch, "dryrun": dryrun,
                      "families": {k: v for k, v in families.items()
                                   if k != "backward"},
                      "fp8": {k: v for k, v in fp8.items()
                              if k != "kernels"},
                      "split": {k: v for k, v in split.items()
                                if k not in ("kernels", "backward")},
                      "seqshard": {k: v for k, v in seq.items()
                                   if k != "kernels"},
                      "ssm_split": {k: v for k, v in ssm_split.items()
                                    if k not in ("kernels", "backward",
                                                 "fake_quant")}}))
    print(json.dumps({"train": {k: v for k, v in training.items()
                                if k != "backward"}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
