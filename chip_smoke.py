#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--phases kernels,serving,serving_quant,
                           serving_auto,lm_serving,lm_serving_quant,
                           lm_serving_sched,lm_families,lm_recurrent,
                           lm_training,lm_tp,lm_tp_families,
                           lm_tp_recurrent,lm_tp_train,lm_pipe_compress,
                           training]
                          [--requests 8]

Phases, in order; any failure ends the run with a non-zero exit:

  1. the card's name and power limit (nvidia-smi), then the build of every
     CUDA kernel from src/repro_torch/kernels/csrc (one nvcc a source, all
     started together) and its time; any spill byte in a K1, K4, K5, K6 or
     K7 kernel fails the run;
  2. kernels: kernel K1 (plan_dds) against its plain PyTorch version on the
     card -- small layout cases (random, padded, spilling, fused QKV, 32x1
     tiles, every epilogue with bias, bf16) through every instance of
     csrc/plan_dds_common.cuh that takes each (stream, tc, fp32, general;
     two calls bitwise equal), then three timed groups of four projection
     shapes with 128x128 tiles at density 0.2 -- BERT-base at M=384 (fp32),
     gemma3_4b's packed projections at M=4 (decode) and M=1024 (prefill,
     bf16) -- each with its instance and kernel and library (torch.matmul
     on the densified weight) times with the queue held and cold (64 MB
     written before each launch), plain time and bound, then the same for
     the lm_families models' packed attention projections (pixtral_12b's
     fused QKV 6144x5120 and wo 5120x4096, qwen3_moe's 9216x4096 and
     4096x8192, deepseek_v2_lite's MLA wq 3072x2048 and wo 2048x2048) and
     the lm_recurrent model's (recurrentgemma_9b's fused QKV 4608x4096,
     attention wo 4096x4096, FFN wi 12288x4096 and wo 4096x12288) at
     M=4 and M=1024, bf16; K4 (dds, dds_t,
     plan_dds_t) and K5 (sddmm, plan_sddmm) against theirs -- the shapes of
     tests/test_kernels.py and 32x1 tiles, fp32 and bf16, padded nnzt
     (padding tiles exactly zero), the spilling plan; each through every
     instance that takes it (K4: ring, general, two calls bitwise equal and
     the ring bitwise equal to general; K5: ring, general, two calls
     bitwise equal, the ring with one split bitwise equal to general) --
     and plan_dds_t / plan_sddmm at the four BERT-base shapes at M=3072
     (the training batch) with K4's instance and block rows and K5's
     instance and split count, kernel and library (torch.matmul of dY with
     the dense weight; of dY^T with X) times held and cold, each one's
     general instance's time beside, plain time and bound; then K2
     (flash_decode) and K3 (paged_flash_decode) against theirs -- ragged
     and scalar pos with inactive slots, shared and per-slot position
     maps, ring windows, T not a multiple of the split count, G = 1 and
     16, scores that rise from split to split, one 4096-row split at
     G = 16 (the chunked two-pass path), empty trailing and fully masked
     middle splits, unmapped and poisoned pages, K3 bit-exact against K2
     over the gathered view -- and at the gemma3_4b decode shapes (B=4,
     Hkv=4, G=2, D=256, bf16; a 1280-slot linear cache, its 80-page paged
     form, a 1024-slot ring) with two calls bitwise equal and kernel,
     plain, bound and library (scaled_dot_product_attention with the same
     mask) times, the kernel's and the library's both warm (50 launches on
     the same caches, which stay in L2) and cold (64 MB written before
     each launch), and at head_dim 128 (B=4, a 1280-slot linear cache and
     its 80 pages; Hkv=8, G=4 as pixtral_12b, Hkv=4, G=16 as qwen3_moe)
     with the same checks and times, and K2 alone at recurrentgemma_9b's
     local layers (Hkv=1, G=16, D=256, 1280 slots, window 2048) and
     whisper_base's decoder (Hkv=8, G=1, D=64, 448 slots). Each K2 / K3
     call is two launches: a split kernel, one
     block per (split, KV head, slot) writing the split's fp32 partial
     (its own max, sum and p.V), then a combine folding the partials in
     split order; then K6
     (plan_dds_q) against its plain version through every instance --
     int8 and fp8, 'block' and 'row' scales, the spilling and a padded
     plan, every epilogue with bias, bf16 x, all-zero blocks -- and the
     same three timed groups with int8 values (library: torch.matmul on the
     dequantized dense weight); and K7 (masked_matmul) against its plain
     version with non-zero values in the masked tiles through each of its
     instances (ring, general; the ring bitwise equal to general) -- the
     shapes of tests/test_kernels.py, 32x1 tiles, bf16, M not a multiple of
     the block, an all-masked tile row -- and at the four BERT-base shapes
     with its instance and block rows and times as K5's (library:
     torch.matmul on w * mask);
  3. serving: BERT-base at full width (12 layers, d=768, d_ff=3072, vocab
     30522, seeded random weights) pruned 80% at 128x128 with tied masks,
     fused QKV and cross-layer union, served through backend 'plan_pallas'
     (every projection through K1): a few (1, 384) requests and one
     (8, 384) batch, logits checked against the dense path on the same
     pruned weights, 12 x 4 K1 launches per forward, then save / reload
     with bit-equal logits;
  3a. serving_quant: the same BERT-base with pack_quant 'int8', then 'fp8':
     48 K6 launches a forward and no K1, logits against the fp32-pack
     servable (tolerance n_layers x quant_stats()['max_rel_err'] x
     max|logits|; the last position's argmax equal unless the reference's
     top-2 margin there is a near-tie), quant_stats with compression >= 3,
     the card's quantized bytes equal to the CPU quantization of the same
     values, ms per request and batch, save / reload bit-equal;
  3b. serving_auto: backend 'auto' with pack_quant 'int8', wall-clock mode
     over a fresh cache: each group's winner and every arm's time, K7
     launched while the masked arm is measured, the winners served (logits
     within 1e-3 of dense, or the quant tolerance when packs are
     quantized), a second prepare answered from the cache for every group;
     then the negative control -- every pattern pinned to 'masked' through
     export_params(backend_chooser=...): 48 K7 launches a forward, logits
     within 1e-3 of dense, ms and projection-weight bytes beside the K1 and
     dense servables;
  4. lm_serving: gemma3_4b at full width and depth (34 layers, bf16,
     seeded random weights) pruned 80% at 128x128, served by the
     continuous-batching engine (4 slots x 1280 positions, fused windows of
     8) in the dense and the paged KV layout: 6 requests (prompts of 37 to
     1100 tokens, 32 new tokens each), every request done, K1 / K2 / K3
     launches per decode step checked against the layer routing, ms per
     decode step and tokens/s, a profiler breakdown of one decode window
     with K1's device ms and share of it, dense vs paged greedy-token
     agreement, and decode_step logits with the kernels against the plain
     decode_attention composition.
  4a. lm_serving_quant: the same gemma3_4b with pack_quant 'int8' through
     the dense-layout engine and the same 6 requests: every request done,
     136 K6 launches per decode step (the unquantized run's K1 count) and
     no K1, the engine's 'quant' stats, ms per decode step and tokens/s, a
     profiler breakdown of one window, greedy-token agreement with the
     bf16-pack run (printed), decode_step logits within 5% of max|logits|
     of the bf16-pack servable's;
  4b. lm_serving_sched: the same gemma3_4b (bf16 packs) through the rest of
     the engine. Chunked prefill (SchedSpec(max_chunk=256, token_budget=
     2048, decode_priority=True)) beside one-shot admission, dense and
     paged KV, on lm_serving's prompts with the 1100-token one submitted
     after two windows: every request done, K1 / K2 / K3 launches equal to
     the layer routing (136 K1 a decode step, a one-shot prefill and a
     chunk; each chunk of the direct chunked prefill checked on its own),
     greedy-token agreement printed, a differing first token failing only
     where the one-shot top-2 margin is at least twice the prefill logits'
     gap, decode_step logits after chunked prefill within 5% of max|logits|
     of the one-shot caches', ms per decode step, tokens/s, K1's instance
     by chunk M and the longest gap between decode windows while the long
     prompt prefilled (chunked and one-shot), a profiler breakdown of one
     chunked window; SLO (fast_fail, max_queue_delay_s=1.0): a request past
     its deadline and one whose projection misses it fail with DEADLINE, a
     burst sized to twice the backlog bound is shed lowest priority first
     (OVERLOAD), everything else done; sampling (temperature 0.8, top_k 64,
     seed 1234): two runs bitwise equal, keys of 4 slots x 64 positions on
     the card equal to the CPU's; int8 KV (kv_cache_quant, one-shot): no
     K2 / K3, 136 K1 a step, decode_step logits within 5% of max|logits|
     of the bf16-KV cache's, KV bytes of both; chaos: the 3rd prefill chunk
     raises, exactly its request fails (prefill_error) and the others are
     done, stats_dict()['watchdog'] present with 0 stalls of a 30 s
     watchdog.
  4c. lm_families: pixtral_12b (vlm; 20 of 40 layers), deepseek_v2_lite_16b
     (MLA + MoE; 9 of 27 layers: the dense first and 8 MoE) and
     qwen3_moe_235b_a22b (MoE; 4 of 94 layers: the whole model does not fit
     80 GB), full width, one after the other (the depths cut to fit
     lm_tp_train in the run's time limit),
     each freed before the next (peak memory printed): seeded bf16 weights
     on the card, pruned 80% at 128x128 with tied masks and served through
     K1 (and K2 / K3 on the GQA attention layers; MLA decodes with the
     plain absorbed composition, no kernel). pixtral: model_forward on
     (1, 512) tokens with 256 seeded patch embeddings, logits with K1
     within 5% of max|logits| of the plain plan composition. Each: the
     engine dense and paged (deepseek: paged latent pools) with
     lm_serving's 6 requests, every request done, K1 / K2 / K3 launches
     equal to the layer routing; decode_step logits with the kernels
     against the plain composition within 5% of max|logits|, and for MoE
     the tokens whose top-k expert set differs between the two (a
     difference fails unless the router's k-th vs (k+1)-th logit margin is
     below twice the router logits' max|delta|); for MoE the chunked-
     prefill gate (SchedSpec(max_chunk=256) logs its blocker and admits
     one-shot); a profiled decode window with the routed-expert bytes
     floor beside its device time.
  4d. lm_recurrent: mamba2_780m (ssm; 24 of 48 layers), recurrentgemma_9b
     (hybrid; 20 of 38 layers: 14 RG-LRU + 6 MQA local-attention) and
     whisper_base (audio enc-dec, 6 + 6 layers, 1500 frames) at full width
     (the two recurrent LMs' depth cut to fit lm_tp_train in the run's
     time limit),
     bf16, one after the other with the lm_families spec: mamba2 has no
     packs and no attention (no kernel on its path), recurrentgemma serves
     its FFNs and local-attention projections through K1 (52 a decode
     step and a prefill; its RG-LRU projections stay dense, as in the
     reference) and its rings through K2 (6 a step), whisper serves dense
     with K2 on its decoder self-attention (6 a step, prefill steps
     included). mamba2 / recurrentgemma: lm_serving's 6 requests with
     kv_layout='paged' asked (the "no linear attention/MLA layers to page"
     blocker logged, served dense), one-shot and with SchedSpec(max_chunk=
     256), every request done, launches equal to the routing, chunked vs
     one-shot tokens (a differing first token only at a near-tie) and
     decode_step logits after both within 5%, a 300-token prompt through
     the one-pass prefill against token-by-token decode prefill within 5%
     of max|logits| (mamba2 also on an fp32 copy, 64 tokens, within 1e-3),
     recurrentgemma's decode_step logits kernels vs plain within 5%.
     whisper: 4 requests of 1500 seeded frames, the 4-token
     start-of-transcript prompt, 64 new tokens, cache_len 448, every
     request done, launches equal to the routing; paged and chunked asked
     (both audio blockers logged, dense one-shot served); decode_step
     logits K2 vs plain at ragged positions and the teacher-forced forward
     against per-step decode within 5%. Each: a profiled decode window,
     peak memory.
  4e. lm_training: LM training. a. flash_attention's backward (the
     reference's FA2-schedule custom VJP, a plain composition) at gemma3_4b's
     global-layer shape (B 1, S 4096, Hq 8, Hkv 4, D 256, chunks 1024,
     causal): dq, dk, dv against autograd through full_attention (fp32
     within 1e-4, bf16 within 2e-2 of max|g|), fwd+bwd ms beside
     full_attention's and SDPA's (a yardstick the port never calls);
     b. gemma3_4b at full width and depth (34 layers, bf16 params, fp32
     AdamW state, the group-lasso prox at 16x16) through
     make_train_step(donate=True) at B 1, S 4096 (train_4k's length, its
     batch cut to 1): a warm-up and 3 timed steps (CUDA events), finite
     losses, every leaf moved, in place, peak memory below the card's,
     tokens/s, 6 N tokens over the bf16 peak as a reading, a profiled step
     (device busy and idle share); c. at full width, 6 layers (one
     5 local : 1 global period), S 2048: gradients with per-period remat
     against plain autograd, bitwise, and the donated update (the embedding in chunks) against a
     functional unchunked one on the same gradients, bitwise; d. the
     Trainer on that model: gradual pruning to 0.7 at 16x16 from step 2 to
     6, the prox, a fault at step 5 (exactly 1 restart from the step-4
     checkpoint), every targeted leaf within 0.02 of 0.7, checkpoint
     host-copy, write and restore times; e. the trained model through
     prepare_servable(prune='none', 16x16 tiles, plan_pallas) and the
     engine: 4 greedy requests done, K1 and K2 launches equal to the
     routing, decode_step logits kernels vs plain within 5%; f. 2 packed
     fine-tuning steps: K1 launches = the forward's plus the remat
     recompute of the period's packs, one K4 and one K5 a packed
     projection (bf16, their general instances, printed), padding slots'
     gradients and values exactly 0, the cross-entropy within 1e-2 of the
     dense forward's on the unpacked weights, and inside a gradient pass
     at M 2048 every K1 output, K4 dX and K5 tile gradient on the step's
     own X and dY within 2^-7 of max|ref| of fp32 products with the dense
     weight (dW gathered at the stored tiles); g. one
     train step of deepseek_7b, chatglm3_6b, internlm2_20b, qwen3_moe,
     deepseek_v2_lite, mamba2_780m, recurrentgemma_9b, pixtral_12b (patch
     embeddings) and whisper_base (frames) at smoke size on the card
     against the CPU (loss and grad norm within 1e-4 relative).
  4f. lm_tp: mesh-first serving, one process per mesh position, all on
     the one card and joined by gloo (the ranks share the card, so their
     step times say nothing of tensor-parallel speed). gemma3_4b at full
     width and depth, lm_serving's spec with tied pruning done once,
     exported three ways with place=False -- tp (1, 4) backend 'plan',
     dp (4, 1) 'plan_pallas' (K1), tp+dp (2, 2) 'plan' -- and handed to
     the ranks through CUDA IPC (place_servable: each rank keeps views of
     its shards); each run against the same export served on one device:
     lm_serving's first 4 requests with 8 new tokens each (cut from 6 x 32
     to make room for lm_tp_families; tp also with paged KV), every
     request done on every rank, K1 / K2 / K3 launches per rank equal to
     the layer routing (K2 on one local KV head, G 2, D 256 under tp), the
     ranks' tokens equal to each other and to the single-device run except
     at near-ties (a differing token fails unless the single-device top-2
     margin there is below twice the decode logits' max |difference|),
     decode_step logits on 4 prefilled slots within 5% of max|logits|,
     per-rank pack bytes <= 1/model of the total where every pack shards,
     each cache leaf's local shape spec_for_cache's shard and never
     changed; printed: per-rank peak memory, ms per decode step by the host
     clock, collectives and their bytes per run and per decode step.
     BERT-base (backend 'plan') saved by one process, loaded by every rank
     of (1, 4) and (1, 2) (memory-mapped shards): the serving traffic,
     logits within 1e-3 of one device. Then what gloo takes on CUDA tensors
     (all_reduce / broadcast / all_gather by dtype: a reading), and K2 / K3
     at a rank's decode shapes beside SDPA and the bound.
  4g. lm_tp_families: the vlm, MoE and MLA families over meshes of four
     processes sharing the card (gloo), one family after the other at
     lm_families' widths (pixtral_12b 40 layers, deepseek_v2_lite_16b 9
     of 27 as lm_families, qwen3_moe_235b_a22b 4 of 94), each pruned
     once and exported per partition with place=False, handed to the
     ranks through CUDA IPC: pixtral tp (1, 4) 'plan' with the vlm
     forward ((1, 300) tokens, 256 patch embeddings handed to every rank)
     against one device; qwen3_moe tp (1, 4) dense and paged (K2 / K3 on
     a rank's KV head, G 16); deepseek tp (1, 4) dense and paged latents,
     dp (4, 1) 'plan_pallas' (K1 on a rank's slot; its MoE layers gather
     the step's rows over "data" and route the whole batch) and tp+dp
     (2, 2). Each run: 2 requests (37, 150 prompt tokens) x 4 new
     tokens, every request done on every rank, launches a rank equal to
     the routing, tokens equal to one device's except at near-ties,
     decode_step logits on 4 prefilled slots within 5% of max|logits|
     (where MoE router flips at near-ties moved them past the bar, one
     device replaying the mesh's routing must meet it), cache leaves
     spec_for_cache's shards, routed experts E/m and c_kv r/m a rank,
     expert bytes a rank <= 1/4 of the total at tp; every router flip
     between the mesh and one device only at a near-tie, printed with its
     margin; printed: peak memory a rank, ms a decode step (host clock),
     collectives a run and a decode step.
  lm_tp_cards (not in the default list; a four-card machine): gemma3_4b
     over tp (1, 4) with one card a rank and NCCL, each rank building its
     shard from the seed; lm_serving's traffic; launches a rank equal to
     the routing, the ranks' tokens equal, tokens equal to the same export
     on one card except at near-ties, decode_step logits within 5%; ms a
     decode step on four cards and on one (host clock).
  4h. lm_tp_train: launch/train.Trainer on meshes of four processes
     sharing the card, their collectives through CUDA IPC staging buffers
     (launch/staging.SharedStaging, installed on the phase's meshes; gloo's
     host round trip would take most of the run): gemma3_4b at full width, 6 layers, B 4 x S 512, gradual
     pruning to 0.7 at 16x16 with the prox, over dp (4, 1) and tp+dp
     (2, 2) for 6 steps (checkpoints every 4, a fault at step 5: exactly
     one restart on every rank) and tp (1, 4) for 2, every step's loss
     and grad_norm equal on every rank and within 1e-3 relative of one
     device's Trainer on the same seed and batches; fp32 copies of dp and
     tp at 2 layers within 1e-5; the (2, 2) step-4 checkpoint restored at
     (1, 4), (4, 1) and on one device, every leaf bitwise its part of the
     file, then 2 steps at (1, 4) against the (2, 2) run's own; BERT-base
     over (1, 4) pruned to 0.8 at 128x128 (tiles straddle the 192-row
     shards), every step's masks equal to one device's except at printed
     near-ties; 2 packed steps over dp (4, 1) through K1 / K4 / K5, 48 of
     each a rank a step, against one device's packed step (1e-4).
     Printed per rank: collectives a step, their bytes and host seconds,
     host seconds a step, param and optimizer bytes, peak memory.
  4i. lm_pipe_compress: block-sparse gradient compression and GPipe on
     four processes sharing the card, their collectives through CUDA IPC
     staging buffers (as lm_tp_train). a. BERT-base at full width (fp32)
     over dp (4, 1), 3 steps of (8, 384) with 2 rows a rank: every leaf
     that optim/compression.compressible admits synced by
     compressed_allreduce (density 0.05, the default 8 x 128 blocks), the
     rest by one fp32 all_reduce, then adamw_update; every rank's params
     and error buffers after each step bitwise a one-process run on the
     card that computes the four ranks' gradients from the same rows,
     compresses them with the same functions and adds the blocks in peer
     order; density 1.0 within 1e-6 of the dense mean; wire bytes a rank
     a step against the dense fp32 all-reduce of the same leaves. b.
     gemma3_4b at full width, 4 stages of one period (5 local + 1 global
     layers: 24 in all), 6 microbatches of (1, 512) bf16 through
     launch/pipeline.pipeline_apply with the LM's own layer body: the
     outputs on every rank against one device running the 24 layers in
     order (bitwise, or 1e-3 of max|y|), the gradients of every stage's
     params and of X against autograd through that run within 1e-3 of
     each leaf's max|g|, and an fp32 copy of 2 layers a stage within
     1e-5; layer_fn runs M times a stage forward and M backward (no bubble
     tick computes), 2 (M + S - 2) ring shifts a rank. c. the same
     periods pruned and packed by prepare_servable ('plan_pallas', 128 x
     128 tiles, union packs over the periods) through the pipeline,
     forward: bitwise the sequential packed run, 24 K1 launches a rank a
     microbatch (fused QKV, wo, ffn wi and wo of 6 layers). Printed: wire
     bytes, ppermute calls and bytes, host seconds, peak memory a rank.
  5. training: BERT-base at full width from seeded random weights,
     trained 12 steps at (8, 384) by launch/train.Trainer with gradual block
     pruning to 80% at 128x128 (attention projections) and one injected
     fault recovered from the step-4 checkpoint (Supervisor.restarts == 1);
     handed to serving with prepare_servable (prune='none', fused QKV,
     cross-layer union, backend 'plan_pallas'); then 4 packed fine-tuning
     steps through make_train_step, each with exactly one K1, K4
     (plan_dds_t) and K5 (plan_sddmm) launch per packed projection (K4's
     and K5's instance by projection printed); the first step's loss and gradient norm against the plain plan
     composition, every padding slot exactly 0 afterwards, a (1, 384)
     forward of the fine-tuned packs against the dense forward of the
     unpacked weights, ms per step of both kinds and a profiler breakdown
     of one packed step.

Each phase prints its seconds ("[phase] ..."). The line before the last is
the kernels JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import copy
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/plan_dds.cu"
COMMON_SOURCE = "src/repro_torch/kernels/csrc/plan_dds_common.cuh"
REPLACES = "src/repro/kernels/bsr_matmul.py:368"
DECODE_SOURCE = "src/repro_torch/kernels/csrc/flash_decode.cu"
DDS_SOURCE = "src/repro_torch/kernels/csrc/dds.cu"
DDS_REPLACES = "src/repro/kernels/bsr_matmul.py:159"
SDDMM_SOURCE = "src/repro_torch/kernels/csrc/sddmm.cu"
SDDMM_REPLACES = "src/repro/kernels/bsr_matmul.py:235"
QUANT_SOURCE = "src/repro_torch/kernels/csrc/plan_dds_q.cu"
QUANT_REPLACES = "src/repro/kernels/bsr_matmul.py:450"
MASKED_SOURCE = "src/repro_torch/kernels/csrc/masked.cu"
MASKED_REPLACES = "src/repro/kernels/bsr_matmul.py:278"
DECODE_REPLACES = {"flash_decode": "src/repro/kernels/flash_decode.py:150",
                   "paged_flash_decode": "src/repro/kernels/flash_decode.py:214"}

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the fp32
# rate outside the tensor cores -- K1 runs fp32 FMA.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# the dense bf16 tensor-core rate: the least time for a product whose x is
# bf16 (K6 at decode, int8 values exactly representable in bf16)
BF16_FLOP_PER_S = 989e12

# Tolerances of K1 against its plain version on the same inputs. Both
# accumulate in fp32 but sum in another order, so the gap scales with the
# output's magnitude: fp32 outputs within 1e-5 of max|ref| (a few hundred
# fp32 roundings of a K <= 3072 dot product), bf16 outputs within 2e-2 of
# max|ref| (one bf16 rounding step of the output, 2^-7, with margin).
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
# Served logits against the dense path on the same pruned weights (the
# repository example's parity bar).
TOL_LOGITS = 1e-3
# K2 / K3 against their plain versions: both fold the same splits with fp32
# math and differ only in summation order, so fp32 outputs agree within 1e-5
# of max|ref| (an output is a convex mix of V rows, |out| <= max|v|); bf16
# outputs within 2e-2 of max|ref|, one bf16 rounding step of the output
# (2^-7) with margin.
TOL_DECODE_F32 = 1e-5
TOL_DECODE_BF16 = 2e-2

MAIN_SHAPES = (("qkv", 2304, 768), ("attn_out", 768, 768),
               ("ffn_in", 3072, 768), ("ffn_out", 768, 3072))
# the lm_families models' packed attention projections, (name, N, K):
# pixtral_12b's fused QKV and wo, qwen3_moe's (64 query / 4 KV heads of
# 128), deepseek_v2_lite's MLA wq and wo (their FFNs are MoE or unpruned)
# -- and the lm_recurrent model's: recurrentgemma_9b's local layers' fused
# QKV (16 query / 1 KV head of 256) and wo, its geglu FFN's wi and wo
FAMILY_SHAPES = (("pixtral", (("wqkv", 6144, 5120), ("wo", 5120, 4096))),
                 ("qwen3_moe", (("wqkv", 9216, 4096), ("wo", 4096, 8192))),
                 ("deepseek_v2_lite", (("wq", 3072, 2048),
                                       ("wo", 2048, 2048))),
                 ("recurrentgemma", (("wqkv", 4608, 4096),
                                     ("attn_wo", 4096, 4096),
                                     ("ffn_wi", 12288, 4096),
                                     ("ffn_wo", 4096, 12288))))


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise PhaseError(msg)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _sparse_weight(rng, n, k, tile, density):
    import numpy as np
    w = rng.randn(n, k).astype(np.float32)
    mask = rng.rand(n // tile[0], k // tile[1]) < density
    return w * np.kron(mask, np.ones(tile, np.float32))


def _plan_case(w, tile, pad_tiles=0):
    from repro_torch.kernels import build_plan, pack_bsr, pack_plan_data
    pk = pack_bsr(w, tile)
    if pad_tiles:
        pk = pack_bsr(w, tile, nnzt=pk.real_nnzt + pad_tiles)
    plan = build_plan(pk)
    return plan, pack_plan_data(plan, pk.data)


# Cycles of torch.cuda._sleep that keep the card busy while the host queues
# the timed launches (~10 ms and ~0.5 ms at the H100's clock): the events
# then time the device, not the host's dispatch of each call.
HOLD_CYCLES = 20_000_000
COLD_HOLD_CYCLES = 1_000_000
# bytes written between launches to push the caches out of the 50 MB L2
FLUSH_BYTES = 64 << 20


def _time_ms(fn, reps: int = 50, warmup: int = 5, hold: bool = False) -> float:
    """Mean ms of ``reps`` back-to-back launches (CUDA events). With
    ``hold`` the launches are queued behind a sleep, so the events time the
    device even where one call takes less device time than its dispatch."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_cold_ms(fn, reps: int = 20) -> float:
    """Mean ms of one launch with a cold L2: FLUSH_BYTES written before each
    launch, the queue held, CUDA events around the launch alone."""
    import torch
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for i, (start, end) in enumerate(events):
        flush.fill_(i % 128)
        torch.cuda._sleep(COLD_HOLD_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def _profile(label, fn, top: int = 8):
    """One call of ``fn`` under torch.profiler: device time by kernel (the
    trace's device-side events only), their total, and the device's idle
    share of the wall time (the profiler's own overhead counts in the wall
    time). Only device activity is recorded, and the rows are summed from
    the trace's raw events: the host's operator events and the profiler's
    own event tree, which no reading uses, took ~36 s to build for one
    chunked window of 42,544 device events. Returns the (ms, count, name)
    rows, largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    rows = [(ms, n, name) for name, (ms, n) in by_name.items()]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f"[profile] {label}: no device time in the trace "
              f"(wall {wall:.3f} ms); device busy share not measured")
        return rows
    print(f"[profile] {label}: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms in {sum(r[1] for r in rows)} device events, "
          f"idle share {max(0.0, 1 - busy / wall):.3f}")
    for ms, count, key in rows[:top]:
        print(f"  {ms:9.4f} ms {count:5d}x  {key[:90]}")
    return rows


def _kernel_share(label, rows):
    """K1's and K6's device ms in profiler rows (their kernels are the
    instances of csrc/plan_dds_common.cuh under the plain or the quantized
    value policy) and their share of the window's device busy time."""
    busy = sum(r[0] for r in rows)
    for kernel, policy in (("K1", "PlainValues"), ("K6", "QuantValues")):
        mine = [r for r in rows if "plan_dds_" in r[2] and policy in r[2]]
        if not mine or not busy:
            continue
        ms, n = sum(r[0] for r in mine), sum(r[1] for r in mine)
        print(f"[profile] {label}: {kernel} {ms:.3f} ms in {n} launches, "
              f"{ms / busy:.3f} of device busy {busy:.3f} ms")


def _compare(name, got, ref, tol_rel, kernel="K1"):
    import torch
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    ok = err <= tol_rel * scale and bool(torch.isfinite(got).all())
    print(f"  {name:34s} max|d|={err:.3e}  tol={tol_rel * scale:.3e}  "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{kernel} disagrees with its plain version on {name}")
    return err


# --------------------------------------------------------------------------
# phase 1: card + build
# --------------------------------------------------------------------------

def phase_build():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    card = out.stdout.strip().splitlines()[0]
    print(card)
    from repro_torch.kernels.build import build_all
    t0 = time.perf_counter()
    logs = build_all(force=True)
    print(f"[build] {len(logs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, info in logs.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for name in ("plan_dds", "dds", "plan_dds_q", "sddmm", "masked"):
        kernels, spilled, fn = 0, [], None
        for line in logs[name]["log"].splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if found:
                kernels += 1
                if found.group(1) != "0" or found.group(2) != "0":
                    spilled.append(f"{fn}: {found.group(0)}")
        check(kernels > 0 and not spilled,
              f"{name}: ptxas reports spills in {spilled}")
        print(f"[build] {name}: {kernels} kernels, 0 spill bytes")
    return card


# --------------------------------------------------------------------------
# phase 2: K1 against its plain version
# --------------------------------------------------------------------------

def _instances(m, tile, x_dtype, v_dtype):
    """The K1 / K6 instances that take a call (bsr_matmul.instance_takes),
    the one plan_instance picks first."""
    from repro_torch.kernels.bsr_matmul import (PLAN_INSTANCES,
                                                instance_takes)
    return [i for i in PLAN_INSTANCES
            if instance_takes(i, m, tile, x_dtype, v_dtype)]


def _kernel_record(kernel, name, m, n, k, tiles, inst, x_dtype, err, fn,
                   plain, lib, n_bytes, flops, flop_rate, general=None):
    """Kernel and library ms with the queue held (device time, the values
    warm in L2) and cold (L2 flushed before each launch, as a decode step
    finds a layer's weights), the plain ms, the bound, and with ``general``
    the general instance's ms held as the kernel's."""
    rec = {"shape": name, "m": m, "n": n, "k": k, "tiles": tiles,
           "instance": inst, "x_dtype": str(x_dtype), "max_abs_err": err,
           "ms": _time_ms(fn, hold=True), "ms_cold": _time_cold_ms(fn),
           "plain_ms": _time_ms(plain, reps=10, warmup=2),
           "library_ms": _time_ms(lib, hold=True),
           "library_ms_cold": _time_cold_ms(lib),
           **_bound(n_bytes, flops, flop_rate)}
    gen = ""
    if general is not None:
        rec["general_ms"] = _time_ms(general, hold=True)
        gen = f"general_ms={rec['general_ms']:.4f} "
    tag = "" if inst is None else f"[{inst}] "
    print(f"  {kernel} {name:9s} M={m} {tag}kernel_ms={rec['ms']:.4f} "
          f"cold={rec['ms_cold']:.4f} {gen}plain_ms={rec['plain_ms']:.4f} "
          f"library_ms={rec['library_ms']:.4f} "
          f"cold={rec['library_ms_cold']:.4f} bound_ms="
          f"{rec['bound_ms']:.5f} ({rec['bound_by']}) tiles={tiles}")
    return rec


def _group_summary(kernel, label, recs):
    tot = _sum_group(recs)
    insts = sorted({r["instance"] for r in recs if r["instance"]})
    tag = f" [{', '.join(insts)}]" if insts else ""
    gen = (f", general instance {tot['general_ms']:.4f} ms"
           if "general_ms" in tot else "")
    print(f"[kernels] {kernel} {label}, {len(recs)} shapes{tag}: "
          f"kernel {tot['ms']:.4f} ms (cold {tot['ms_cold']:.4f}){gen}, "
          f"library {tot['library_ms']:.4f} ms (cold "
          f"{tot['library_ms_cold']:.4f}), plain {tot['plain_ms']:.4f} ms, "
          f"bound {tot['bound_ms']:.5f} ms; "
          f"kernel below library: warm {tot['ms'] < tot['library_ms']}, "
          f"cold {tot['ms_cold'] < tot['library_ms_cold']}")


def phase_kernels(seed: int):
    """K1 against its plain version on the card: the small layout cases
    through every instance that takes each, then timed shapes -- BERT-base's
    four projections at M=384 (fp32), gemma3_4b's four packed projections
    and the lm_families models' two each at M=4 (decode) and M=1024
    (prefill), bf16."""
    import numpy as np
    import torch
    from repro_torch.kernels import (plan_dds, plan_fused_linear,
                                     plan_fused_linear_plain, plan_instance,
                                     plan_linear, plan_matmul_pallas,
                                     plan_schedule)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(seed)

    def run_all(name, plan, data, x, tol, bias=None, act=None):
        """Every instance that takes the case, against the plain version;
        two calls of each bitwise equal."""
        ref = plan_fused_linear_plain(x, data, plan, bias=bias, act=act)
        for inst in _instances(x.shape[0], plan.tile, x.dtype, data.dtype):
            kw = dict(n=plan.shape[0], tile=plan.tile, bias=bias, act=act,
                      instance=inst)
            y = plan_dds(x, data, plan_schedule(plan), **kw)
            _compare(f"{name} [{inst}]", y, ref, tol)
            check(torch.equal(y, plan_dds(x, data, plan_schedule(plan),
                                          **kw)),
                  f"K1 [{inst}] {name}: two calls differ")

    print("[kernels] K1 plan_dds vs plain, small cases, every instance that "
          "takes each (two calls bitwise equal)")
    cases = [("random d=0.4 (16,32)", 96, 128, (16, 32), 0.4, 0, 24),
             ("random d=0.15 (16,32)", 96, 128, (16, 32), 0.15, 0, 24),
             ("padded nnzt +5 (16,32)", 96, 128, (16, 32), 0.4, 5, 24),
             ("(32,1) tiles", 64, 64, (32, 1), 0.3, 0, 40),
             ("(16,16) M=130", 64, 96, (16, 16), 0.5, 0, 130),
             ("(16,16) M=4", 64, 96, (16, 16), 0.5, 0, 4)]
    for name, n, k, tile, dens, pad, m in cases:
        plan, data = _plan_case(_sparse_weight(rng, n, k, tile, dens), tile,
                                pad)
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
        run_all(name, plan, data.to(dev), x, TOL_F32)

    # the spilling pattern of test_plan_pallas_spill_schedule_edge_rows
    n, k, tile = 128, 1024, (16, 64)
    w = np.zeros((n, k), np.float32)
    w[:16, :] = rng.randn(16, k)
    for i in range(1, 8):
        w[16 * i: 16 * (i + 1), 64 * i: 64 * (i + 1)] = \
            0.1 * rng.randn(16, 64)
    plan, data = _plan_case(w, tile)
    check(plan.spilled, "spill case did not spill")
    for m in (20, 3):
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
        run_all(f"spill edge rows (16,64) M={m}", plan, data.to(dev), x,
                TOL_F32)
        run_all(f"spill edge rows (16,64) M={m} bf16", plan,
                data.to(dev, torch.bfloat16), x.bfloat16(), TOL_BF16)

    # fused-QKV pack through the batched entry, leading dims preserved, then
    # through every instance
    k, tile = 64, (16, 16)
    w = np.concatenate([_sparse_weight(rng, 48, k, tile, 0.5)
                        for _ in range(3)])
    plan, data = _plan_case(w, tile)
    data = data.to(dev)
    x = torch.from_numpy(rng.randn(2, 5, k).astype(np.float32)).to(dev)
    y = plan_matmul_pallas(x, data, plan)
    check(tuple(y.shape) == (2, 5, 144), f"fused QKV shape {tuple(y.shape)}")
    ref = plan_linear(x.reshape(10, k), data, plan).reshape(2, 5, 144)
    _compare("fused QKV (16,16) batched", y, ref, TOL_F32)
    run_all("fused QKV (16,16)", plan, data, x.reshape(10, k), TOL_F32)
    run_all("fused QKV (16,16) bf16", plan, data.bfloat16(),
            x.reshape(10, k).bfloat16(), TOL_BF16)

    # every epilogue, with bias
    n, k, tile = 64, 96, (16, 16)
    plan, data = _plan_case(_sparse_weight(rng, n, k, tile, 0.5), tile)
    data = data.to(dev)
    b = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    for m in (16, 40):
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
        for act in (None, "relu", "gelu", "silu"):
            y = plan_fused_linear(x, data, plan, bias=b, act=act)
            ref = plan_fused_linear_plain(x, data, plan, bias=b, act=act)
            _compare(f"epilogue bias+{act} M={m}", y, ref, TOL_F32)
            run_all(f"epilogue bias+{act} M={m}", plan, data, x, TOL_F32,
                    bias=b, act=act)

    # bf16 values (ServingSpec.dtype='bfloat16' casts only the packs), and
    # bf16 activations too
    n, k, tile = 256, 256, (128, 128)
    plan, data = _plan_case(_sparse_weight(rng, n, k, tile, 0.5), tile)
    d16 = data.to(dev, torch.bfloat16)
    for m in (48, 4):
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
        run_all(f"x fp32, values bf16 M={m}", plan, d16, x, TOL_F32)
        run_all(f"x bf16, values bf16 M={m}", plan, d16, x.bfloat16(),
                TOL_BF16)
        run_all(f"x bf16, values fp32 +gelu M={m}", plan, data.to(dev),
                x.bfloat16(), TOL_BF16, act="gelu")

    groups = {}
    timed = [("bert_m384", MAIN_SHAPES, 384, torch.float32, FP32_FLOP_PER_S,
              TOL_F32),
             ("gemma_m4", GEMMA_SHAPES, 4, torch.bfloat16, BF16_FLOP_PER_S,
              TOL_BF16),
             ("gemma_m1024", GEMMA_SHAPES, 1024, torch.bfloat16,
              BF16_FLOP_PER_S, TOL_BF16)]
    timed += [(f"{model}_m{m}", shapes, m, torch.bfloat16, BF16_FLOP_PER_S,
               TOL_BF16) for model, shapes in FAMILY_SHAPES for m in (4, 1024)]
    for label, shapes, m, dtype, flop_rate, tol in timed:
        print(f"[kernels] K1 {label}: M={m}, 128x128 tiles, density 0.2, "
              f"{dtype}")
        recs = []
        tile = (128, 128)
        for name, n, k in shapes:
            w = _sparse_weight(rng, n, k, tile, 0.2)
            plan, data = _plan_case(w, tile)
            data = data.to(dev, dtype)
            x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(
                dev, dtype)
            w_dense = torch.from_numpy(w).to(dev, dtype)
            sched = plan_schedule(plan)
            kw = dict(n=n, tile=tile)
            inst = plan_instance(m, tile, dtype, dtype)
            y = plan_dds(x, data, sched, **kw)
            err = _compare(f"{name} ({n},{k}) M={m} [{inst}]", y,
                           plan_linear(x, data, plan), tol)
            _compare(f"{name} vs torch.matmul", y,
                     torch.matmul(x, w_dense.t()), tol)
            nnz = plan.real_nnzt * tile[0] * tile[1]
            isz = x.element_size()
            recs.append(_kernel_record(
                "K1", name, m, n, k, plan.real_nnzt, inst, dtype, err,
                lambda: plan_dds(x, data, sched, **kw),
                lambda: plan_linear(x, data, plan),
                lambda: torch.matmul(x, w_dense.t()),
                isz * (m * k + nnz + m * n), 2 * m * nnz, flop_rate))
        _group_summary("K1", label, recs)
        groups[label] = recs
    return groups


# --------------------------------------------------------------------------
# phase 2a: K4 (dds, dds_t, plan_dds_t) and K5 (sddmm, plan_sddmm) against
# their plain versions
# --------------------------------------------------------------------------

# (M, N, K, tile, density) of tests/test_kernels.py's sweep, plus the paper's
# (32, 1) tile
BWD_SHAPES = ((32, 128, 128, (32, 64), 0.4), (64, 256, 128, (64, 128), 0.25),
              (100, 128, 384, (32, 128), 0.5), (16, 512, 256, (128, 128), 0.1),
              (8, 64, 64, (64, 64), 1.0), (40, 64, 96, (32, 1), 0.3))
TRAIN_M = 3072      # (8, 384) tokens: the packed fine-tuning batch


def phase_backward_kernels(seed: int):
    """K4 and K5 against their plain versions on the card: every entry
    point on the small cases (fp32 and bf16, padded nnzt, (32, 1) tiles,
    the spilling plan), then plan_dds_t / plan_sddmm at the BERT-base
    projection shapes at M=3072 with times."""
    import numpy as np
    import torch
    from repro_torch.kernels import bsr_matmul as bm
    from repro_torch.kernels.bsr_matmul import pack_bsr
    from repro_torch.kernels.exec_plan import plan_schedule, plan_t_schedule
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed + 3)

    def tol(dtype):
        return TOL_F32 if dtype == torch.float32 else TOL_BF16

    print("[kernels] K4 dds / dds_t and K5 sddmm vs plain, small cases")
    for m, n, k, tile, dens in BWD_SHAPES:
        w = _sparse_weight(rng, n, k, tile, dens)
        for pad in (0, 3):
            pk = pack_bsr(w, tile)
            if pad:
                pk = pack_bsr(w, tile, nnzt=pk.real_nnzt + pad)
            for dtype in (torch.float32, torch.bfloat16):
                dn = "fp32" if dtype == torch.float32 else "bf16"
                name = f"{m}x({n},{k}) {tile} +{pad} {dn}"
                data = torch.from_numpy(pk.data).to(dev, dtype)
                x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(
                    dev, dtype)
                dy = torch.from_numpy(rng.randn(m, n).astype(np.float32)).to(
                    dev, dtype)
                _k4_all(f"dds {name}", lambda **kw: bm.dds(
                            x, pk, data, **kw),
                        bm.dds_plain(x, pk, data), tol(dtype), m, tile,
                        dtype, False)
                _k4_all(f"dds_t {name}", lambda **kw: bm.dds_t(
                            dy, pk, data, **kw),
                        bm.dds_t_plain(dy, pk, data), tol(dtype), m, tile,
                        dtype, True)
                _k5_all(f"sddmm {name}", lambda **kw: bm.sddmm(
                            dy, x, pk, data, **kw),
                        bm.sddmm_plain(dy, x, pk, data), tol(dtype), m, tile,
                        dtype, pk.real_nnzt)

    print("[kernels] K4 plan_dds_t and K5 plan_sddmm vs plain, plan cases")
    spill = np.zeros((128, 1024), np.float32)
    spill[:16, :] = rng.randn(16, 1024)
    for i in range(1, 8):
        spill[16 * i: 16 * (i + 1), 64 * i: 64 * (i + 1)] = \
            0.1 * rng.randn(16, 64)
    cases = [("random d=0.4 (16,32) +5", _sparse_weight(
                  rng, 96, 128, (16, 32), 0.4), (16, 32), 5, 24),
             ("spill edge rows (16,64)", spill, (16, 64), 0, 20),
             ("(32,1) tiles", _sparse_weight(rng, 64, 64, (32, 1), 0.3),
              (32, 1), 0, 40)]
    for name, w, tile, pad, m in cases:
        plan, data = _plan_case(w, tile, pad)
        n, k = w.shape
        for dtype in (torch.float32, torch.bfloat16):
            dn = "fp32" if dtype == torch.float32 else "bf16"
            d = data.to(dev, dtype)
            x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(
                dev, dtype)
            dy = torch.from_numpy(rng.randn(m, n).astype(np.float32)).to(
                dev, dtype)
            ts, s = plan_t_schedule(plan), plan_schedule(plan)
            _k4_all(f"plan_dds_t {name} {dn}", lambda **kw: bm.plan_dds_t(
                        dy, d, ts, k=k, tile=tile, **kw),
                    bm.plan_dds_t_plain(dy, d, ts, k=k, tile=tile),
                    tol(dtype), m, tile, dtype, True)
            _k5_all(f"plan_sddmm {name} {dn}", lambda **kw: bm.plan_sddmm(
                        dy, x, s, tile=tile, **kw),
                    bm.plan_sddmm_plain(dy, x, s, tile=tile), TOL_F32, m,
                    tile, dtype, s.n_tiles)

    print(f"[kernels] K4 plan_dds_t and K5 plan_sddmm at the BERT-base "
          f"projection shapes, M={TRAIN_M}, 128x128 tiles, density 0.2")
    per_shape = {"dds": [], "sddmm": []}
    m, tile = TRAIN_M, (128, 128)
    for name, n, k in MAIN_SHAPES:
        w = _sparse_weight(rng, n, k, tile, 0.2)
        plan, data = _plan_case(w, tile)
        data = data.to(dev)
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
        dy = torch.from_numpy(rng.randn(m, n).astype(np.float32)).to(dev)
        w_dense = torch.from_numpy(w).to(dev)
        ts, s = plan_t_schedule(plan), plan_schedule(plan)
        nnz = plan.real_nnzt * tile[0] * tile[1]
        flops = 2 * m * nnz
        for kname, fn, plain, lib, n_bytes in (
                ("dds", lambda: bm.plan_dds_t(dy, data, ts, k=k, tile=tile),
                 lambda: bm.plan_dds_t_plain(dy, data, ts, k=k, tile=tile),
                 lambda: torch.matmul(dy, w_dense),
                 4 * (m * n + nnz + m * k)),
                ("sddmm", lambda: bm.plan_sddmm(dy, x, s, tile=tile),
                 lambda: bm.plan_sddmm_plain(dy, x, s, tile=tile),
                 lambda: torch.matmul(dy.t(), x),
                 4 * (m * n + m * k + nnz))):
            kern = "K4" if kname == "dds" else "K5"
            err = _compare(f"{kern} {name} ({n},{k})", fn(), plain(),
                           TOL_F32, kern)
            if kname == "sddmm":
                inst = bm.sddmm_instance(m, tile, x.dtype)
                if inst == "ring":
                    inst += f" S={bm.sddmm_splits(m, s.n_tiles, tile)[0]}"
                general = functools.partial(bm.plan_sddmm, dy, x, s,
                                            tile=tile, instance="general")
            else:
                inst = bm.dds_instance(m, tile, dy.dtype, True)
                if inst == "ring":
                    inst += (f" {bm.dds_block_rows(m, ts.n_out, tile[1])} "
                             f"rows")
                general = functools.partial(bm.plan_dds_t, dy, data, ts, k=k,
                                            tile=tile, instance="general")
            per_shape[kname].append(_kernel_record(
                kern, name, m, n, k, plan.real_nnzt, inst, x.dtype, err, fn,
                plain, lib, n_bytes, flops, FP32_FLOP_PER_S, general))
    _group_summary("K4 plan_dds_t", f"M={m}", per_shape["dds"])
    _group_summary("K5 plan_sddmm", f"M={m}", per_shape["sddmm"])
    return per_shape


def _k4_all(name, fn, ref, tol, m, tile, dtype, transposed):
    """K4 through every instance that takes the call against its plain
    version: two calls bitwise equal, and the ring bitwise equal to the
    general instance (one fmaf chain an output, in the same order)."""
    import torch
    from repro_torch.kernels import bsr_matmul as bm
    out = {}
    for inst in bm.DDS_INSTANCES:
        if not bm.dds_takes(inst, m, tile, dtype, transposed):
            continue
        y = fn(instance=inst)
        _compare(f"K4 {name} [{inst}]", y, ref, tol, "K4")
        check(torch.equal(y, fn(instance=inst)),
              f"K4 [{inst}] {name}: two calls differ")
        out[inst] = y
    if "ring" in out:
        check(torch.equal(out["ring"], out["general"]),
              f"K4 {name}: the ring differs from general")


def _k5_all(name, fn, ref, tol, m, tile, dtype, n_real):
    """K5 through every instance that takes the call against its plain
    version: padding tiles exactly zero, two calls bitwise equal, and the
    ring with one split bitwise equal to the general instance."""
    import torch
    from repro_torch.kernels import bsr_matmul as bm
    out = {}
    for inst in bm.SDDMM_INSTANCES:
        if not bm.sddmm_takes(inst, m, tile, dtype):
            continue
        g = fn(instance=inst)
        s = bm.sddmm_splits(m, n_real, tile)[0] if inst == "ring" else 1
        _compare(f"K5 {name} [{inst} S={s}]", g, ref, tol, "K5")
        check(float(g[n_real:].float().abs().sum()) == 0.0,
              f"K5 [{inst}] {name} wrote a non-zero padding tile")
        check(torch.equal(g, fn(instance=inst)),
              f"K5 [{inst}] {name}: two calls differ")
        out[inst] = g
    if "ring" in out:
        check(torch.equal(fn(instance="ring", splits=1), out["general"]),
              f"K5 {name}: the ring with one split differs from general")


# --------------------------------------------------------------------------
# phase 2b: K2 (flash_decode) and K3 (paged_flash_decode) against their plain
# versions
# --------------------------------------------------------------------------

def _decode_inputs(rng, dev, dtype, b, t, hq, hkv, d):
    import numpy as np
    import torch

    def rnd(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dtype)
    return rnd(b, 1, hq, d), rnd(b, t, hkv, d), rnd(b, t, hkv, d)


def _ring_map(t, pos):
    """Slot j of a T-slot ring holds the latest position <= pos congruent to
    j (-1 where none): the map a ring cache has after writing 0..pos."""
    import numpy as np
    j = np.arange(t)
    src = j + t * ((pos - j) // t)
    return np.where((src >= 0) & (src <= pos), src, -1).astype(np.int32)


def _decode_bound_ms(kvp, pos, window, b, hq, hkv, d, itemsize):
    """Least time for one decode call: the K and V rows of the visible
    positions, the position map, pos, q and out over the HBM rate, against
    4 * visible * Hq * D fp32 operations (q.k and p.v) over the fp32 rate."""
    import numpy as np
    posv = np.broadcast_to(np.asarray(pos), (b,))[:, None]
    kv = np.broadcast_to(np.asarray(kvp), (b, np.asarray(kvp).shape[-1]))
    ok = (kv >= 0) & (kv <= posv)
    if window > 0:
        ok &= kv > posv - window
    vis = int(ok.sum())
    n_bytes = (2 * vis * hkv * d * itemsize + kv.size * 4 + b * 4
               + 2 * b * hq * d * itemsize)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 4 * vis * (hq // hkv) * d / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _sdpa_fn(q, k, v, kvp, pos, window):
    """One torch.nn.functional.scaled_dot_product_attention call with the
    same boolean mask and enable_gqa=True: the yardstick."""
    import torch
    import torch.nn.functional as F
    b = q.shape[0]
    kvp = kvp if kvp.dim() == 2 else kvp[None].expand(b, -1)
    posv = pos.reshape(-1, 1).expand(b, 1)
    ok = (kvp >= 0) & (kvp <= posv)
    if window > 0:
        ok &= kvp > posv - window
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = ok[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def _decode_times(fn, plain, sdpa, plain_reps=50):
    """Kernel and SDPA ms warm (50 launches on the same caches, which stay
    in L2) and cold (L2 flushed before each launch), and the plain ms."""
    return {"ms": _time_ms(fn, hold=True), "ms_cold": _time_cold_ms(fn),
            "plain_ms": _time_ms(plain, reps=plain_reps,
                                 warmup=min(5, plain_reps)),
            "library_ms": _time_ms(sdpa, hold=True),
            "library_ms_cold": _time_cold_ms(sdpa)}


# the lm_families and lm_recurrent models' decode attention, B = 4 ragged
# slots on a linear bf16 cache: (label, Hkv, G, D, T, window, with K3 on
# its pages of 16). pixtral_12b and qwen3_moe at D = 128 (their global
# layers page); recurrentgemma_9b's MQA local layers (window 2048, a ring
# of min(1280, 2048) = 1280 slots) and whisper_base's decoder (a 448-slot
# linear cache), neither of which pages; gemma3_4b's decode on one rank of
# a 4-wide model axis (lm_tp: 1 local KV head of 4, G 2, D 256), its global
# layers on 1280 slots (and their pages) and its local rings of 1024;
# whisper_base's decoder on one rank of a 4-wide model axis
# (lm_tp_recurrent: 2 of its 8 KV heads)
DECODE_FAMILY_SHAPES = (("pixtral_g4", 8, 4, 128, 1280, 0, True),
                        ("qwen3_g16", 4, 16, 128, 1280, 0, True),
                        ("recurrentgemma_g16_d256", 1, 16, 256, 1280, 2048,
                         False),
                        ("whisper_g1_d64", 8, 1, 64, 448, 0, False),
                        ("gemma3_tp4_g2_d256", 1, 2, 256, 1280, 0, True),
                        ("whisper_tp4_g1_d64", 2, 1, 64, 448, 0, False),
                        ("gemma3_tp4_ring_g2_d256", 1, 2, 256, 1024, 1024,
                         False))


def _decode_family_shapes(rng, dev, per_shape, labels=None):
    """K2 at each DECODE_FAMILY_SHAPES entry, B = 4 ragged positions, and K3
    on the paged ones' shuffled pages -- for G = 16 a split of more than
    512 rows takes the two-pass path (G * rows > 8192) -- against the plain
    versions, K3 bit-exact against K2, two calls bitwise equal, with
    times."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain,
                                                  paged_flash_decode,
                                                  paged_flash_decode_plain)
    from repro_torch.models.common import paged_view
    i32, dtype = torch.int32, torch.bfloat16
    b, ps = 4, 16
    for label, hkv, g, d, t, window, paged in DECODE_FAMILY_SHAPES:
        if labels is not None and label not in labels:
            continue
        posl = ([1279, 1105, 700, 333] if t == 1280
                else [t - 1, (t * 7) // 8, t // 2, t // 4])
        hq = hkv * g
        q, k, v = _decode_inputs(rng, dev, dtype, b, t, hq, hkv, d)
        kvp = torch.arange(t, dtype=i32, device=dev)[None].expand(b, t)
        kvp = torch.where(kvp <= torch.tensor(posl, device=dev)[:, None], kvp,
                          torch.full_like(kvp, -1)).contiguous()
        pos = torch.tensor(posl, dtype=i32, device=dev)
        out = flash_decode(q, k, v, kvp, pos, window=window)
        err = _compare(f"K2 {label} T={t} D={d}", out, flash_decode_plain(
            q, k, v, kvp, pos, window=window), TOL_DECODE_BF16, "K2")
        torch.cuda.synchronize()
        check(torch.equal(out, flash_decode(q, k, v, kvp, pos,
                                            window=window)),
              f"K2 {label}: two calls differ")
        bound, by = _decode_bound_ms(kvp.cpu().numpy(), posl, window, b, hq,
                                     hkv, d, 2)
        sdpa = _sdpa_fn(q, k, v, kvp, pos, window)
        per_shape[f"{label}_{t}"] = {
            "t": t, "hkv": hkv, "g": g, "d": d, "window": window,
            "max_abs_err": err,
            **_decode_times(lambda: flash_decode(q, k, v, kvp, pos,
                                                 window=window),
                            lambda: flash_decode_plain(q, k, v, kvp, pos,
                                                       window=window),
                            sdpa),
            "bound_ms": bound, "bound_by": by}
        if not paged:
            print(f"  K2 {label}: Hq={hq}, Hkv={hkv}, G={g}, D={d}, T={t}; "
                  f"repeatable: ok")
            continue
        npg = t // ps
        perm = torch.from_numpy(rng.permutation(b * npg).astype(
            np.int32)).to(dev)
        table = perm.reshape(b, npg).contiguous()
        kp = torch.empty((b * npg, ps, hkv, d), dtype=dtype, device=dev)
        vp = torch.empty_like(kp)
        kp[table.long()] = k.reshape(b, npg, ps, hkv, d)
        vp[table.long()] = v.reshape(b, npg, ps, hkv, d)
        out3 = paged_flash_decode(q, kp, vp, table, kvp, pos)
        err3 = _compare(f"K3 {label} T=1280 (80 pages)", out3,
                        paged_flash_decode_plain(q, kp, vp, table, kvp, pos),
                        TOL_DECODE_BF16, "K3")
        same = flash_decode(q, paged_view(kp, table, kvp),
                            paged_view(vp, table, kvp), kvp, pos,
                            kv_split=npg)
        torch.cuda.synchronize()
        check(torch.equal(out3, same), f"K3 {label} is not bit-exact "
              "against K2 over the gathered view")
        check(torch.equal(out3, paged_flash_decode(q, kp, vp, table, kvp,
                                                   pos)),
              f"K3 {label}: two calls differ")
        per_shape[f"{label}_paged_{t}"] = {
            "t": t, "page_size": ps, "hkv": hkv, "g": g, "d": d,
            "max_abs_err": err3,
            **_decode_times(lambda: paged_flash_decode(q, kp, vp, table, kvp,
                                                       pos),
                            lambda: paged_flash_decode_plain(
                                q, kp, vp, table, kvp, pos),
                            sdpa, plain_reps=5),
            "bound_ms": bound, "bound_by": by}
        print(f"  K2/K3 {label}: Hq={hq}, Hkv={hkv}, G={g}, D={d}; K3 "
              f"bit-exact vs K2, both repeatable: ok")


def phase_decode_kernels(seed: int):
    """K2 and K3 against their plain versions on the card: the small
    layout cases, then the gemma3_4b decode shapes with times."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_plain, paged_flash_decode,
        paged_flash_decode_plain)
    from repro_torch.models.common import paged_view
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed + 1)
    i32 = torch.int32

    def tol(dtype):
        return TOL_DECODE_F32 if dtype == torch.float32 else TOL_DECODE_BF16

    print("[kernels] K2 flash_decode vs plain, small cases")
    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        # ragged pos with an inactive row, per-slot (B, T) maps, T = 30 not a
        # multiple of 4 splits, window 0 and 8
        b, t, hq, hkv, d = 3, 30, 8, 4, 16
        q, k, v = _decode_inputs(rng, dev, dtype, b, t, hq, hkv, d)
        kvp = torch.arange(t, dtype=i32, device=dev)[None].expand(b, t)
        kvp = kvp.contiguous()
        pos = torch.tensor([t - 1, -1, 11], dtype=i32, device=dev)
        for window in (0, 8):
            for ks in (1, 2, 4):
                out = flash_decode(q, k, v, kvp, pos, window=window,
                                   kv_split=ks)
                ref = flash_decode_plain(q, k, v, kvp, pos, window=window,
                                         kv_split=ks)
                _compare(f"K2 {dn} ragged w={window} split={ks}", out, ref,
                         tol(dtype), "K2")
                check(float(out[1].float().abs().max()) == 0.0,
                      "K2: an inactive slot did not give zeros")
        # MHA (G = 1), scalar pos, shared (T,) map
        b, t, h, d = 2, 24, 4, 8
        q, k, v = _decode_inputs(rng, dev, dtype, b, t, h, h, d)
        kvp = torch.arange(t, dtype=i32, device=dev)
        out = flash_decode(q, k, v, kvp, t - 1)
        _compare(f"K2 {dn} MHA scalar pos shared map", out,
                 flash_decode_plain(q, k, v, kvp, t - 1), tol(dtype), "K2")
        # G = 16 (chatglm3's grouping), D = 128
        b, t, hq, hkv, d = 2, 200, 32, 2, 128
        q, k, v = _decode_inputs(rng, dev, dtype, b, t, hq, hkv, d)
        kvp = torch.arange(t, dtype=i32, device=dev)
        pos = torch.tensor([199, 57], dtype=i32, device=dev)
        _compare(f"K2 {dn} G=16 D=128", flash_decode(q, k, v, kvp, pos),
                 flash_decode_plain(q, k, v, kvp, pos), tol(dtype), "K2")
        # a wrapped ring: T = 32 slots, window 32, positions past T
        b, t, hq, hkv, d = 2, 32, 4, 2, 64
        q, k, v = _decode_inputs(rng, dev, dtype, b, t, hq, hkv, d)
        posl = [70, 40]
        kvp = torch.from_numpy(np.stack([_ring_map(t, p) for p in posl])).to(
            dev)
        pos = torch.tensor(posl, dtype=i32, device=dev)
        _compare(f"K2 {dn} ring wrap window=32",
                 flash_decode(q, k, v, kvp, pos, window=32),
                 flash_decode_plain(q, k, v, kvp, pos, window=32),
                 tol(dtype), "K2")

    print("[kernels] K2 split-parallel edge cases: a max that rises in "
          "later splits, a long single split, empty trailing splits")
    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        # scores that grow with t (up to ~8): every combine step rescales
        b, t, hq, hkv, d = 2, 256, 8, 4, 64
        q = torch.from_numpy(np.abs(rng.randn(b, 1, hq, d)).astype(
            np.float32)).to(dev, dtype)
        ramp = 0.005 * np.arange(t, dtype=np.float32)[None, :, None, None]
        k = torch.from_numpy(0.1 * rng.randn(b, t, hkv, d).astype(np.float32)
                             + ramp).to(dev, dtype)
        v = torch.from_numpy(rng.randn(b, t, hkv, d).astype(np.float32)).to(
            dev, dtype)
        kvp = torch.arange(t, dtype=i32, device=dev)
        pos = torch.tensor([t - 1, 200], dtype=i32, device=dev)
        for ks in (4, 8):
            _compare(f"K2 {dn} rising max split={ks}",
                     flash_decode(q, k, v, kvp, pos, kv_split=ks),
                     flash_decode_plain(q, k, v, kvp, pos, kv_split=ks),
                     tol(dtype), "K2")
        # one split of 4096 rows at G = 16: its scores do not fit shared
        # memory, so the split goes in chunks in two passes
        b, t, hq, hkv, d = 2, 4096, 32, 2, 128
        q, k, v = _decode_inputs(rng, dev, dtype, b, t, hq, hkv, d)
        kvp = torch.arange(t, dtype=i32, device=dev)
        pos = torch.tensor([t - 1, 2000], dtype=i32, device=dev)
        _compare(f"K2 {dn} T=4096 G=16 D=128 split=1",
                 flash_decode(q, k, v, kvp, pos, kv_split=1),
                 flash_decode_plain(q, k, v, kvp, pos, kv_split=1),
                 tol(dtype), "K2")
        # T = 10 over 8 splits of 2: splits 5-7 are empty; slot 1's middle
        # split is fully masked, slot 2 is inactive
        b, t, hq, hkv, d = 3, 10, 4, 2, 32
        q, k, v = _decode_inputs(rng, dev, dtype, b, t, hq, hkv, d)
        kvp = torch.arange(t, dtype=i32, device=dev)[None].repeat(b, 1)
        kvp[1, 4:6] = -1
        pos = torch.tensor([9, 9, -1], dtype=i32, device=dev)
        out = flash_decode(q, k, v, kvp, pos, kv_split=8)
        _compare(f"K2 {dn} empty and masked splits", out,
                 flash_decode_plain(q, k, v, kvp, pos, kv_split=8),
                 tol(dtype), "K2")
        check(float(out[2].float().abs().max()) == 0.0,
              "K2: an inactive slot did not give zeros")

    print("[kernels] K3 paged_flash_decode vs plain and vs K2, small cases")
    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        b, npg, ps, hkv, hq, d = 2, 4, 8, 2, 4, 16
        kp = torch.from_numpy(rng.randn(b * npg + 3, ps, hkv, d).astype(
            np.float32)).to(dev, dtype)
        vp = torch.from_numpy(rng.randn(b * npg + 3, ps, hkv, d).astype(
            np.float32)).to(dev, dtype)
        table = torch.tensor([[2, 5, 7, -1], [1, 9, -1, -1]], dtype=i32,
                             device=dev)
        pm = torch.full((b, npg * ps), -1, dtype=i32, device=dev)
        pm[0, :3 * ps] = torch.arange(3 * ps, dtype=i32, device=dev)
        pm[1, :2 * ps] = torch.arange(2 * ps, dtype=i32, device=dev)
        pos = torch.tensor([3 * ps - 1, ps + 3], dtype=i32, device=dev)
        q = torch.from_numpy(rng.randn(b, 1, hq, d).astype(np.float32)).to(
            dev, dtype)
        out = paged_flash_decode(q, kp, vp, table, pm, pos)
        _compare(f"K3 {dn} holes in the table", out,
                 paged_flash_decode_plain(q, kp, vp, table, pm, pos),
                 tol(dtype), "K3")
        kv, vv = paged_view(kp, table, pm), paged_view(vp, table, pm)
        dense = flash_decode(q, kv, vv, pm, pos, kv_split=npg)
        torch.cuda.synchronize()
        check(torch.equal(out, dense), "K3 is not bit-exact against K2 over "
              "the gathered view")
        print(f"  K3 {dn} bit-exact vs K2 over the gathered view: ok")
        # stale and poisoned unmapped pages never leak into the result
        kp2, vp2 = kp.clone(), vp.clone()
        for pg in (0, 3, 4, 6, 8, 10):
            kp2[pg] = 1e4
            vp2[pg] = float("nan")
        again = paged_flash_decode(q, kp2, vp2, table, pm, pos)
        torch.cuda.synchronize()
        check(torch.equal(out, again), "K3 read a stale or unmapped page")
        print(f"  K3 {dn} stale and NaN pages ignored: ok")

    print("[kernels] K2 and K3 at the gemma3_4b decode shapes: B=4, Hkv=4, "
          "G=2, D=256, bf16")
    per_shape = {}
    b, hkv, g, d = 4, 4, 2, 256
    hq = hkv * g
    dtype = torch.bfloat16

    def repeatable(name, fn, out):
        again = fn()
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"{name}: two calls on the same "
              "inputs differ")
        print(f"  {name}: two calls bitwise equal: ok")

    # global layers: a linear cache of 1280 slots (ragged, all active)
    posl = [1279, 1105, 700, 333]
    t = 1280
    q, k, v = _decode_inputs(rng, dev, dtype, b, t, hq, hkv, d)
    kvp = torch.arange(t, dtype=i32, device=dev)[None].expand(b, t)
    kvp = torch.where(kvp <= torch.tensor(posl, device=dev)[:, None], kvp,
                      torch.full_like(kvp, -1)).contiguous()
    pos = torch.tensor(posl, dtype=i32, device=dev)
    out = flash_decode(q, k, v, kvp, pos)
    err = _compare("K2 global T=1280", out, flash_decode_plain(
        q, k, v, kvp, pos), TOL_DECODE_BF16, "K2")
    repeatable("K2 global T=1280", lambda: flash_decode(q, k, v, kvp, pos),
               out)
    bound, by = _decode_bound_ms(kvp.cpu().numpy(), posl, 0, b, hq, hkv, d,
                                 2)
    sdpa_global = _sdpa_fn(q, k, v, kvp, pos, 0)
    per_shape["global_1280"] = {
        "t": t, "window": 0, "max_abs_err": err,
        **_decode_times(lambda: flash_decode(q, k, v, kvp, pos),
                        lambda: flash_decode_plain(q, k, v, kvp, pos),
                        sdpa_global),
        "bound_ms": bound, "bound_by": by}
    # the same cache paged: 80 pages of 16 positions, pages shuffled
    ps = 16
    npg = t // ps
    perm = torch.from_numpy(rng.permutation(b * npg).astype(np.int32)).to(dev)
    table = perm.reshape(b, npg).contiguous()
    kp = torch.empty((b * npg, ps, hkv, d), dtype=dtype, device=dev)
    vp = torch.empty_like(kp)
    kp[table.long()] = k.reshape(b, npg, ps, hkv, d)
    vp[table.long()] = v.reshape(b, npg, ps, hkv, d)
    out3 = paged_flash_decode(q, kp, vp, table, kvp, pos)
    err3 = _compare("K3 global T=1280 (80 pages)", out3,
                    paged_flash_decode_plain(q, kp, vp, table, kvp, pos),
                    TOL_DECODE_BF16, "K3")
    same = flash_decode(q, paged_view(kp, table, kvp),
                        paged_view(vp, table, kvp), kvp, pos, kv_split=npg)
    torch.cuda.synchronize()
    check(torch.equal(out3, same), "K3 is not bit-exact against K2 at the "
          "main-path shape")
    print("  K3 bit-exact vs K2 over the gathered view (80 splits): ok")
    repeatable("K3 global T=1280 (80 pages)",
               lambda: paged_flash_decode(q, kp, vp, table, kvp, pos), out3)
    per_shape["paged_1280"] = {
        "t": t, "page_size": ps, "max_abs_err": err3,
        **_decode_times(lambda: paged_flash_decode(q, kp, vp, table, kvp,
                                                   pos),
                        lambda: paged_flash_decode_plain(
                            q, kp, vp, table, kvp, pos),
                        sdpa_global, plain_reps=5),
        "bound_ms": bound, "bound_by": by}
    glob = (q, k, v, kvp, pos)
    # local layers: a 1024-slot ring, window 1024, positions past the ring
    t, window = 1024, 1024
    posl = [1279, 1105, 700, 333]
    q, k, v = _decode_inputs(rng, dev, dtype, b, t, hq, hkv, d)
    kvp_np = np.stack([_ring_map(t, p) for p in posl])
    kvp = torch.from_numpy(kvp_np).to(dev)
    pos = torch.tensor(posl, dtype=i32, device=dev)
    out = flash_decode(q, k, v, kvp, pos, window=window)
    err = _compare("K2 ring T=1024 window=1024", out, flash_decode_plain(
        q, k, v, kvp, pos, window=window), TOL_DECODE_BF16, "K2")
    repeatable("K2 ring T=1024 window=1024",
               lambda: flash_decode(q, k, v, kvp, pos, window=window), out)
    bound, by = _decode_bound_ms(kvp_np, posl, window, b, hq, hkv, d, 2)
    per_shape["ring_1024"] = {
        "t": t, "window": window, "max_abs_err": err,
        **_decode_times(lambda: flash_decode(q, k, v, kvp, pos,
                                             window=window),
                        lambda: flash_decode_plain(q, k, v, kvp, pos,
                                                   window=window),
                        _sdpa_fn(q, k, v, kvp, pos, window)),
        "bound_ms": bound, "bound_by": by}
    _decode_family_shapes(rng, dev, per_shape)
    qg, kg, vg, kvpg, posg = glob

    def ten_each():
        for _ in range(10):
            flash_decode(qg, kg, vg, kvpg, posg)
            paged_flash_decode(qg, kp, vp, table, kvpg, posg)
            flash_decode(q, k, v, kvp, pos, window=window)
    # device time of the split and the combine launches apart
    _profile("K2 global, K3 paged, K2 ring: 10 calls each", ten_each)
    for name, rec in per_shape.items():
        print(f"  {name:12s} kernel_ms={rec['ms']:.4f} (cold "
              f"{rec['ms_cold']:.4f}) plain_ms={rec['plain_ms']:.4f} "
              f"library_ms={rec['library_ms']:.4f} (cold "
              f"{rec['library_ms_cold']:.4f}) bound_ms="
              f"{rec['bound_ms']:.5f} ({rec['bound_by']}) "
              f"max|d|={rec['max_abs_err']:.3e}")
    return per_shape


# --------------------------------------------------------------------------
# phase 2c: K6 (plan_dds_q) and K7 (masked_matmul) against their plain
# versions
# --------------------------------------------------------------------------

# gemma3_4b's packed projections at one decode step (fused QKV, attn wo,
# ffn wi, ffn wo): (name, N, K)
GEMMA_SHAPES = (("qkv", 4096, 2560), ("attn_out", 2560, 2048),
                ("ffn_in", 10240, 2560), ("ffn_out", 2560, 10240))
# (M, N, K, tile, density) of tests/test_kernels.py's SHAPES[:4]
MASKED_SHAPES = ((32, 128, 128, (32, 64), 0.4), (64, 256, 128, (64, 128), 0.25),
                 (100, 128, 384, (32, 128), 0.5),
                 (16, 512, 256, (128, 128), 0.1))


def _quantized_case(w, tile, qdtype, pad_tiles=0):
    from repro_torch.kernels.exec_plan import (quant_granularity,
                                               quantize_plan_values)
    plan, data = _plan_case(w, tile, pad_tiles)
    gran = quant_granularity(tile)
    q, s = quantize_plan_values(data, qdtype, gran)
    return plan, data, q, s, gran


def _bound(n_bytes, flops, flop_rate):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flop_rate
    return {"bytes_ms": t_bytes * 1e3, "operations_ms": t_ops * 1e3,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_quant_kernels(seed: int):
    """K6 against its plain version on the card through every instance that
    takes each case: int8 and fp8, 'block' and 'row' scales, the spilling
    and a padded plan, every epilogue with bias, bf16 x, all-zero blocks;
    then timed shapes -- BERT-base's four projections at M=384 (int8, fp32
    x), gemma3_4b's four packed projections at M=4 and M=1024 (int8, bf16
    x)."""
    import numpy as np
    import torch
    from repro_torch.kernels.bsr_matmul import (plan_dds_q, plan_dds_q_plain,
                                                plan_instance)
    from repro_torch.kernels.exec_plan import (dequantize_plan_values,
                                               plan_schedule,
                                               quantize_plan_values)
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed + 5)

    def run_all(name, plan, q, s, gran, x, tol, bias=None, act=None):
        """Every instance that takes the case, against the plain version;
        two calls of each bitwise equal. Returns the last output."""
        kw = dict(n=plan.shape[0], tile=plan.tile, granularity=gran,
                  bias=bias, act=act)
        sched = plan_schedule(plan)
        ref = plan_dds_q_plain(x, q, s, sched, **kw)
        for inst in _instances(x.shape[0], plan.tile, x.dtype, q.dtype):
            y = plan_dds_q(x, q, s, sched, instance=inst, **kw)
            _compare(f"K6 {name} [{inst}]", y, ref, tol, "K6")
            check(torch.equal(y, plan_dds_q(x, q, s, sched, instance=inst,
                                            **kw)),
                  f"K6 [{inst}] {name}: two calls differ")
        return y

    print("[kernels] K6 plan_dds_q vs plain, small cases, every instance "
          "that takes each (two calls bitwise equal)")
    spill = np.zeros((128, 1024), np.float32)
    spill[:16, :] = rng.randn(16, 1024)
    for i in range(1, 8):
        spill[16 * i: 16 * (i + 1), 64 * i: 64 * (i + 1)] = \
            0.1 * rng.randn(16, 64)
    cases = [("random d=0.4 (16,32)", _sparse_weight(rng, 96, 128, (16, 32),
                                                     0.4), (16, 32), 0, 24),
             ("padded nnzt +5 (16,32)", _sparse_weight(
                 rng, 96, 128, (16, 32), 0.4), (16, 32), 5, 24),
             ("(32,1) tiles, row scales", _sparse_weight(
                 rng, 64, 64, (32, 1), 0.3), (32, 1), 0, 40),
             ("spill edge rows (16,64)", spill, (16, 64), 0, 20),
             ("spill edge rows (16,64) M=3", spill, (16, 64), 0, 3),
             ("(16,16) M=130", _sparse_weight(rng, 64, 96, (16, 16), 0.5),
              (16, 16), 0, 130)]
    for name, w, tile, pad, m in cases:
        for qdtype in ("int8", "fp8"):
            plan, _, q, s, gran = _quantized_case(w, tile, qdtype, pad)
            check(gran == ("row" if tile == (32, 1) else "block"),
                  f"{name}: granularity {gran}")
            if name.startswith("spill"):
                check(plan.spilled, "spill case did not spill")
            x = torch.from_numpy(rng.randn(m, w.shape[1]).astype(
                np.float32)).to(dev)
            run_all(f"{name} {qdtype}", plan, q.to(dev), s.to(dev), gran, x,
                    TOL_F32)
    # 'row' scales on tiles the vector instances take (the scale of tile t
    # is scales[t / P] there too)
    n, k, tile = 64, 96, (16, 16)
    plan, data = _plan_case(_sparse_weight(rng, n, k, tile, 0.5), tile)
    for qdtype in ("int8", "fp8"):
        q, s = quantize_plan_values(data, qdtype, "row")
        for m in (5, 40):
            x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
            run_all(f"(16,16) row scales M={m} {qdtype}", plan, q.to(dev),
                    s.to(dev), "row", x, TOL_F32)
    # every epilogue with bias
    plan, _, q, s, gran = _quantized_case(
        _sparse_weight(rng, n, k, tile, 0.5), tile, "int8")
    q, s = q.to(dev), s.to(dev)
    b = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    for m in (4, 16):
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
        for act in (None, "relu", "gelu", "silu"):
            run_all(f"epilogue bias+{act} M={m}", plan, q, s, gran, x,
                    TOL_F32, b, act)
    # bf16 activations, both value types
    n, k, tile = 256, 256, (128, 128)
    w = _sparse_weight(rng, n, k, tile, 0.5)
    for m in (48, 4):
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(
            dev, torch.bfloat16)
        for qdtype in ("int8", "fp8"):
            plan, _, q, s, gran = _quantized_case(w, tile, qdtype)
            run_all(f"x bf16 {qdtype} +gelu M={m}", plan, q.to(dev),
                    s.to(dev), gran, x, TOL_BF16, act="gelu")
    # all-zero blocks: scale exactly 1.0, and a block row whose tiles are
    # all zero gives exactly zero
    n, k, tile = 64, 64, (16, 16)
    plan, data = _plan_case(_sparse_weight(rng, n, k, tile, 0.6), tile)
    data[0] = 0.0                      # every tile of block row 0 (vrow 0)
    for qdtype in ("int8", "fp8"):
        q, s = quantize_plan_values(data, qdtype, "block")
        check(bool((s[0] == 1.0).all()), "all-zero blocks: scale not 1.0")
        for m in (24, 4):
            x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
            y = run_all(f"all-zero block row {qdtype} M={m}", plan,
                        q.to(dev), s.to(dev), "block", x, TOL_F32)
            check(float(y[:, :tile[0]].abs().max()) == 0.0,
                  "K6: an all-zero block row gave a non-zero output")
        print(f"  K6 all-zero block row {qdtype}: scale 1.0, output "
              f"exactly 0: ok")

    groups = {}
    for label, shapes, m, x_dtype, flop_rate, tol in (
            ("bert_m384", MAIN_SHAPES, 384, torch.float32, FP32_FLOP_PER_S,
             TOL_F32),
            ("gemma_m4", GEMMA_SHAPES, 4, torch.bfloat16, BF16_FLOP_PER_S,
             TOL_BF16),
            ("gemma_m1024", GEMMA_SHAPES, 1024, torch.bfloat16,
             BF16_FLOP_PER_S, TOL_BF16)):
        print(f"[kernels] K6 {label}: M={m}, 128x128 tiles, density 0.2, "
              f"int8, {x_dtype} x")
        recs = []
        tile = (128, 128)
        for name, n, k in shapes:
            w = _sparse_weight(rng, n, k, tile, 0.2)
            plan, _, q, s, gran = _quantized_case(w, tile, "int8")
            q, s = q.to(dev), s.to(dev)
            x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(
                dev, x_dtype)
            sched = plan_schedule(plan)
            kw = dict(n=n, tile=tile, granularity=gran)
            inst = plan_instance(m, tile, x_dtype, q.dtype)
            y = plan_dds_q(x, q, s, sched, **kw)
            err = _compare(f"K6 {name} ({n},{k}) M={m} [{inst}]", y,
                           plan_dds_q_plain(x, q, s, sched, **kw), tol, "K6")
            # the library call: one torch.matmul on the dequantized dense
            # weight (the dequantize step is not timed)
            deq = dequantize_plan_values(q, s)
            tiles = deq.reshape(-1, *tile)[torch.from_numpy(
                sched.tile_seq.astype(np.int64)).to(dev)]
            wd = torch.zeros((n // tile[0], k // tile[1]) + tile, device=dev)
            wd[torch.from_numpy(sched.row_ids.astype(np.int64)).to(dev),
               torch.from_numpy(sched.col_seq.astype(np.int64)).to(dev)] = \
                tiles
            wd = wd.permute(0, 2, 1, 3).reshape(n, k).to(x_dtype)
            _compare(f"K6 {name} vs torch.matmul", y,
                     torch.matmul(x, wd.t()), tol, "K6")
            nnz = plan.real_nnzt * tile[0] * tile[1]
            isz = x.element_size()
            recs.append(_kernel_record(
                "K6", name, m, n, k, plan.real_nnzt, inst, x_dtype, err,
                lambda: plan_dds_q(x, q, s, sched, **kw),
                lambda: plan_dds_q_plain(x, q, s, sched, **kw),
                lambda: torch.matmul(x, wd.t()),
                isz * (m * k + m * n) + nnz + 4 * plan.real_nnzt,
                2 * m * nnz, flop_rate))
        _group_summary("K6", label, recs)
        groups[label] = recs
    return groups


def phase_masked_kernels(seed: int):
    """K7 against its plain version on the card, with non-zero values left
    in the masked tiles (skipping is what is tested): the shapes of
    tests/test_kernels.py, (32, 1) tiles, bf16, M not a multiple of the
    block; then the four BERT-base shapes at M=384, density 0.2, with
    kernel, plain, bound and library times."""
    import numpy as np
    import torch
    from repro_torch.kernels.bsr_matmul import (MASKED_INSTANCES,
                                                masked_block_rows,
                                                masked_instance,
                                                masked_matmul,
                                                masked_matmul_plain,
                                                masked_takes)
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed + 6)

    def case(m, n, k, tile, density, dtype=torch.float32, r=rng):
        w = torch.from_numpy(r.randn(n, k).astype(np.float32)).to(
            dev, dtype)          # dense: the masked tiles hold values too
        mask = r.rand(n // tile[0], k // tile[1]) < density
        x = torch.from_numpy(r.randn(m, k).astype(np.float32)).to(
            dev, dtype)
        return x, w, mask

    print("[kernels] K7 masked_matmul vs plain, masked tiles non-zero, "
          "every instance that takes each (ring bitwise equal to general)")
    cases = [(m, n, k, tile, d, torch.float32, rng)
             for m, n, k, tile, d in MASKED_SHAPES]
    cases += [(40, 64, 64, (32, 1), 0.3, torch.float32, rng),
              (130, 256, 256, (128, 128), 0.5, torch.bfloat16, rng),
              (100, 128, 384, (32, 128), 0.5, torch.bfloat16, rng),
              (17, 256, 512, (128, 128), 0.5, torch.float32,
               np.random.RandomState(seed + 7))]
    for m, n, k, tile, d, dtype, r in cases:
        x, w, mask = case(m, n, k, tile, d, dtype, r)
        mask[0, :] = False                  # an all-masked tile row
        dn = "fp32" if dtype == torch.float32 else "bf16"
        ref = masked_matmul_plain(x, w, mask, tile=tile)
        full = torch.matmul(x.float(), w.float().t())
        ys = {}
        for inst in MASKED_INSTANCES:
            if not masked_takes(inst, m, tile, dtype, dtype):
                continue
            y = ys[inst] = masked_matmul(x, w, mask, tile=tile, instance=inst)
            _compare(f"K7 {m}x({n},{k}) {tile} d={d} {dn} [{inst}]", y, ref,
                     TOL_F32 if dtype == torch.float32 else TOL_BF16, "K7")
            check(float((y.float() - full).abs().max()) > 1e-2,
                  "K7 did not skip the masked tiles")
            check(float(y[:, :tile[0]].abs().max()) == 0.0,
                  "K7: an all-masked tile row gave a non-zero output")
        if "ring" in ys:
            check(torch.equal(ys["ring"], ys["general"]),
                  f"K7 {m}x({n},{k}) {tile}: ring differs from general")

    print("[kernels] K7 at the BERT-base projection shapes, M=384, 128x128 "
          "tiles, density 0.2")
    per_shape = []
    m, tile = 384, (128, 128)
    for name, n, k in MAIN_SHAPES:
        x, w, mask = case(m, n, k, tile, 0.2)
        mask_dev = torch.from_numpy(mask.astype(np.int32)).to(dev)
        wm = w * torch.from_numpy(np.kron(mask, np.ones(tile)).astype(
            np.float32)).to(dev)
        y = masked_matmul(x, w, mask_dev, tile=tile)
        err = _compare(f"K7 {name} ({n},{k})", y,
                       masked_matmul_plain(x, w, mask, tile=tile), TOL_F32,
                       "K7")
        _compare(f"K7 {name} vs torch.matmul(w * mask)", y,
                 torch.matmul(x, wm.t()), TOL_F32, "K7")
        stored = int(mask.sum())
        nnz = stored * tile[0] * tile[1]
        # the least work for the same function: the stored tiles only
        n_bytes = 4 * (m * k + nnz + m * n) + 4 * mask.size
        inst = masked_instance(m, tile, x.dtype, w.dtype)
        if inst == "ring":
            inst += f" {masked_block_rows(m, n, tile)} rows"
        per_shape.append(_kernel_record(
            "K7", name, m, n, k, stored, inst, x.dtype, err,
            lambda: masked_matmul(x, w, mask_dev, tile=tile),
            lambda: masked_matmul_plain(x, w, mask_dev, tile=tile),
            lambda: torch.matmul(x, wm.t()), n_bytes, 2 * m * nnz,
            FP32_FLOP_PER_S,
            lambda: masked_matmul(x, w, mask_dev, tile=tile,
                                  instance="general")))
    _group_summary("K7 masked_matmul", f"M={m}", per_shape)
    return per_shape


# --------------------------------------------------------------------------
# phase 3: BERT-base block-sparse serving through K1
# --------------------------------------------------------------------------

def phase_serving(seed: int, n_requests: int):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pruner import tied_prune
    from repro_torch.kernels import plan_dds
    from repro_torch.models.api import init_model, model_forward
    from repro_torch.serving import (ServingSpec, load_servable,
                                     prepare_servable)
    dev = torch.device("cuda")
    cfg = get_config("bert_base")
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size)
          == (12, 768, 3072, 30522), "not BERT-base at full width")
    spec = ServingSpec(tile=(128, 128), sparsity=0.8, prune="tied",
                       fuse_qkv=True, cross_layer_union=True,
                       backend="plan_pallas")
    t0 = time.perf_counter()
    params = init_model(seed, cfg, device=dev)
    servable = prepare_servable(params, cfg, spec, device=dev)
    pruned, _ = tied_prune(params, spec.sparsity_config())
    torch.cuda.synchronize()
    st = servable.stats()
    print(f"[serving] {cfg.arch}: prune + export {time.perf_counter() - t0:.1f}"
          f" s; {st['packed_projections']} packed projections, "
          f"{st['unique_patterns']} unique patterns, density "
          f"{st['density']:.3f}, registry {st['registry']}")
    total, _ = servable.pack_bytes()
    print(f"[serving] pack bytes {total}")

    rng = np.random.RandomState(seed)
    seq = 384
    reqs = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq))).to(dev)
            for _ in range(n_requests)]
    batch8 = torch.from_numpy(rng.randint(0, cfg.vocab_size, (8, seq))).to(dev)

    def dense(tokens):
        return model_forward(pruned, cfg, {"tokens": tokens})[0]

    # warm up both paths (first K1 launch loads the library)
    servable.forward(reqs[0])
    dense(reqs[0])
    torch.cuda.synchronize()

    # --- the counted main-path run: every count set to 0 just before
    per_forward = cfg.n_layers * 4
    plan_dds.launches = 0
    outs = []
    for toks in reqs + [batch8]:
        before = plan_dds.launches
        outs.append(servable.forward(toks))
        check(plan_dds.launches - before == per_forward,
              f"K1 launched {plan_dds.launches - before} times in one "
              f"forward, expected {per_forward}")
    torch.cuda.synchronize()
    launches = plan_dds.launches
    print(f"[serving] K1 launches over {len(outs)} forwards: {launches} "
          f"({per_forward} per forward)")

    worst = 0.0
    for toks, y in zip(reqs + [batch8], outs):
        check(tuple(y.shape) == (toks.shape[0], seq, cfg.vocab_size),
              f"logits shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), "non-finite logits")
        worst = max(worst, float((y - dense(toks)).abs().max()))
    print(f"[serving] parity vs dense on the same pruned weights: "
          f"max |d logits| = {worst:.3e} (tol {TOL_LOGITS})")
    check(worst <= TOL_LOGITS, "served logits disagree with the dense path")

    for name, fn in (("dense", dense), ("BSR", servable.forward)):
        ms = []
        for toks in reqs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(toks)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[serving] {name:5s} ms/request (1, {seq}) over {len(ms)}: "
              f"median {np.median(ms):.3f}, min {min(ms):.3f}, "
              f"max {max(ms):.3f}")
    for name, fn in (("dense", dense), ("BSR", servable.forward)):
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(batch8)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[serving] {name:5s} ms for the (8, {seq}) batch over 3: "
              f"median {np.median(ms):.3f}, min {min(ms):.3f}")
    _profile(f"BSR forward (1, {seq})", lambda: servable.forward(reqs[0]))
    _profile(f"dense forward (1, {seq})", lambda: dense(reqs[0]))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert_sparse")
        servable.save(path)
        again = load_servable(path, device=dev)
        check(again.spec == spec, "reloaded spec differs")
        y2 = again.forward(reqs[0])
        check(torch.equal(y2, outs[0]), "reloaded logits are not bit-equal")
    print("[serving] save -> load_servable: logits bit-equal")
    return {"plan_dds": launches}


# --------------------------------------------------------------------------
# phases 3a and 3b: BERT-base with quantized packs through K6; backend
# 'auto' and the masked negative control through K7
# --------------------------------------------------------------------------

BERT_SPEC = dict(tile=(128, 128), sparsity=0.8, prune="tied", fuse_qkv=True,
                 cross_layer_union=True)


def _bert_setup(seed: int, n_requests: int):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import init_model
    dev = torch.device("cuda")
    cfg = get_config("bert_base")
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size)
          == (12, 768, 3072, 30522), "not BERT-base at full width")
    params = init_model(seed, cfg, device=dev)
    rng = np.random.RandomState(seed)
    reqs = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 384))).to(dev)
            for _ in range(n_requests)]
    batch8 = torch.from_numpy(rng.randint(0, cfg.vocab_size, (8, 384))).to(
        dev)
    return cfg, params, reqs, batch8


def _serve_times(fn, reqs, batch8):
    """(median ms per (1, 384) request, median ms per (8, 384) batch over 3),
    host clock around synchronized calls."""
    import numpy as np
    import torch

    def one(toks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(toks)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    fn(reqs[0])
    return (float(np.median([one(t) for t in reqs])),
            float(np.median([one(batch8) for _ in range(3)])))


def _leaf(params, key):
    _, i, group, name = key.split("/")
    return params["layers"][int(i)][group][name]


def _logit_gap(name, outs, refs, tol):
    """max |d logits| against the reference run, checked against ``tol``;
    the argmax at the last position of every sequence must agree unless the
    reference's top-2 margin there is below 2 * max |d| (a near-tie, which
    either answer within the tolerance may break)."""
    import torch
    err = max(float((y.float() - r.float()).abs().max())
              for y, r in zip(outs, refs))
    same = ties = rows = 0
    for y, r in zip(outs, refs):
        a, b = y[:, -1].argmax(-1), r[:, -1].argmax(-1)
        top2 = torch.topk(r[:, -1].float(), 2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        rows += a.numel()
        same += int((a == b).sum())
        bad = (a != b) & (margin >= 2 * err)
        ties += int(((a != b) & (margin < 2 * err)).sum())
        check(not bool(bad.any()), f"{name}: argmax at the last position "
              f"differs where the reference margin exceeds 2 max|d|")
    print(f"  {name}: max |d logits| = {err:.4e} (tol {tol:.4e}); argmax at "
          f"the last position equal in {same} of {rows} rows ({ties} near-"
          f"ties)")
    check(err <= tol, f"{name}: logits differ by {err:.4e} > {tol:.4e}")
    return err


def phase_serving_quant(seed: int, n_requests: int):
    """BERT-base at full width with backend 'plan_pallas' and pack_quant
    'int8', then 'fp8': every projection through K6, 48 launches a forward
    and no K1; logits against the fp32-pack (K1) servable on the same
    pruned weights; quant_stats; the card's quantized bytes against the CPU
    quantization of the same values; ms per request and batch; save /
    reload bit-equal."""
    import torch
    from repro_torch.kernels import plan_dds, plan_dds_q
    from repro_torch.kernels.exec_plan import QuantPlan, quantize_plan_values
    from repro_torch.serving import (ServingSpec, load_servable,
                                     prepare_servable)
    dev = torch.device("cuda")
    cfg, params, reqs, batch8 = _bert_setup(seed, n_requests)
    fp = prepare_servable(params, cfg, ServingSpec(
        backend="plan_pallas", **BERT_SPEC), device=dev)
    refs = [fp.forward(t) for t in reqs + [batch8]]
    fp_ms = _serve_times(fp.forward, reqs, batch8)
    print(f"[serving_quant] fp32 packs (K1): {fp_ms[0]:.3f} ms per (1, 384) "
          f"request, {fp_ms[1]:.3f} ms per (8, 384) batch; pack bytes "
          f"{fp.pack_bytes()[0]}")
    per_forward = 4 * cfg.n_layers
    counts = {"plan_dds_q": 0, "plan_dds": 0}
    for qdtype in ("int8", "fp8"):
        spec = ServingSpec(backend="plan_pallas", pack_quant=qdtype,
                           **BERT_SPEC)
        sv = prepare_servable(params, cfg, spec, device=dev)
        qs = sv.quant_stats()
        print(f"[serving_quant] {qdtype}: quant_stats {json.dumps(qs)}")
        check(qs["quantized_packs"] == per_forward and qs["qdtype"] == qdtype,
              f"{qdtype}: {qs['quantized_packs']} quantized packs")
        check(qs["compression_ratio"] >= 3.0,
              f"{qdtype}: compression {qs['compression_ratio']:.3f} < 3.0")
        # the card's quantization against the CPU's, byte for byte
        for key, pk in sv.packs.items():
            check(isinstance(pk, QuantPlan) and pk.backend == "plan_pallas",
                  f"{key}: pack {type(pk).__name__}")
            q_cpu, s_cpu = quantize_plan_values(
                _leaf(fp.params, key)["w"].cpu(), qdtype, pk.granularity)
            got = _leaf(sv.params, key)
            check(torch.equal(got["w"].cpu().view(torch.uint8),
                              q_cpu.view(torch.uint8))
                  and torch.equal(got["scale"].cpu(), s_cpu),
                  f"{key}: the card's {qdtype} bytes differ from the CPU's")
        print(f"[serving_quant] {qdtype}: quantized bytes on the card equal "
              f"the CPU quantization of the same values in all "
              f"{len(sv.packs)} packs")
        sv.forward(reqs[0])
        torch.cuda.synchronize()
        # --- the counted main-path run: every count set to 0 just before
        plan_dds_q.launches = 0
        plan_dds.launches = 0
        outs = []
        for toks in reqs + [batch8]:
            before = plan_dds_q.launches
            outs.append(sv.forward(toks))
            check(plan_dds_q.launches - before == per_forward,
                  f"{qdtype}: K6 launched {plan_dds_q.launches - before} "
                  f"times in one forward, expected {per_forward}")
        torch.cuda.synchronize()
        check(plan_dds.launches == 0, f"{qdtype}: K1 launched "
              f"{plan_dds.launches} times")
        counts["plan_dds_q"] += plan_dds_q.launches
        counts["plan_dds"] += plan_dds.launches
        print(f"[serving_quant] {qdtype}: K6 launches over {len(outs)} "
              f"forwards: {plan_dds_q.launches} ({per_forward} per forward), "
              f"K1 {plan_dds.launches}")
        for toks, y in zip(reqs + [batch8], outs):
            check(tuple(y.shape) == (toks.shape[0], 384, cfg.vocab_size)
                  and bool(torch.isfinite(y).all()),
                  f"{qdtype}: logits {tuple(y.shape)} or non-finite")
        # tolerance: every packed weight is within max_rel_err of its pack's
        # largest value; taking one such relative error of the residual
        # stream per encoder layer, carried linearly to the logits, bounds
        # the logits' error by n_layers * max_rel_err * max|logits|
        scale = max(float(r.abs().max()) for r in refs)
        tol = cfg.n_layers * qs["max_rel_err"] * scale
        _logit_gap(f"{qdtype} vs fp32 packs", outs, refs, tol)
        ms = _serve_times(sv.forward, reqs, batch8)
        print(f"[serving_quant] {qdtype}: {ms[0]:.3f} ms per (1, 384) "
              f"request, {ms[1]:.3f} ms per (8, 384) batch; pack bytes "
              f"{sv.pack_bytes()[0]} (fp32 packs {fp.pack_bytes()[0]})")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"bert_{qdtype}")
            sv.save(path)
            again = load_servable(path, device=dev)
            check(again.spec == spec, "reloaded spec differs")
            check(torch.equal(again.forward(reqs[0]), outs[0]),
                  f"{qdtype}: reloaded logits are not bit-equal")
        print(f"[serving_quant] {qdtype}: save -> load_servable: logits "
              f"bit-equal")
        del sv, again
    return counts


def phase_serving_auto(seed: int, n_requests: int):
    """BERT-base at full width with backend 'auto' and pack_quant 'int8' in
    wall-clock mode over a fresh cache (every arm measured on the card,
    K7 included), the winners served, a second prepare answered from the
    cache; then the negative control: the same pruned weights exported
    with every pattern pinned to 'masked' (K7, 48 launches a forward),
    beside the K1 and dense servables."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.pattern_reuse import PatternRegistry
    from repro_torch.core.pruner import tied_prune
    from repro_torch.kernels import bsr_matmul as bm
    from repro_torch.kernels import plan_dds, plan_dds_q
    from repro_torch.models.api import model_forward
    from repro_torch.serving import ServingSpec, export_params
    from repro_torch.serving import prepare_servable
    from repro_torch.serving.servable import Servable, pinned_chooser
    dev = torch.device("cuda")
    cfg, params, reqs, batch8 = _bert_setup(seed, n_requests)
    spec = ServingSpec(backend="auto", pack_quant="int8", **BERT_SPEC)
    pruned, _ = tied_prune(params, spec.sparsity_config())

    def dense(tokens):
        with torch.inference_mode():
            return model_forward(pruned, cfg, {"tokens": tokens})[0]
    refs = [dense(t) for t in reqs + [batch8]]
    counters = {"plan_dds": plan_dds, "plan_dds_q": plan_dds_q,
                "masked_matmul": bm.masked_matmul, "dds": bm.dds}
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "autotune.json")
        os.environ["REPRO_AUTOTUNE_CACHE"] = cache
        os.environ.pop("REPRO_AUTOTUNE_STUB", None)
        # --- the counted main-path run: every count set to 0 just before
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        sv = prepare_servable(params, cfg, spec, device=dev)
        t_tune = time.perf_counter() - t0
        auto = sv.stats()["autotune"]
        print(f"[serving_auto] prepare with measurement {t_tune:.1f} s; "
              f"mode {auto['mode']}, winners {auto['backends']}, cache "
              f"misses {auto['cache_misses']}")
        check(auto["mode"] == "wallclock" and auto["cache_hits"] == 0,
              f"autotune {auto}")
        with open(cache) as f:
            entries = json.load(f)["entries"]
        for key, rec in sorted(entries.items()):
            costs = {k: round(v * 1e3, 4) for k, v in rec["costs"].items()}
            print(f"  {key}: winner {rec['backend']}; ms per arm {costs}")
        check(len(entries) == len(auto["backends"]), "one entry a group")
        k7_measured = bm.masked_matmul.launches
        print(f"[serving_auto] launches while measuring: "
              f"{ {n: fn.launches for n, fn in counters.items()} }")
        check(k7_measured > 0, "the masked arm never launched K7")
        for toks in reqs + [batch8]:
            sv.forward(toks)
        torch.cuda.synchronize()
        paths["serving_auto"] = {n: fn.launches for n, fn in
                                 counters.items()}
        outs = [sv.forward(t) for t in reqs + [batch8]]
        again = prepare_servable(params, cfg, spec, device=dev)
        auto2 = again.stats()["autotune"]
        print(f"[serving_auto] second prepare: cache hits "
              f"{auto2['cache_hits']} of {len(auto2['backends'])} groups")
        check(auto2["cache_hits"] == len(auto2["backends"])
              and auto2["backends"] == auto["backends"],
              "the second prepare did not hit the cache for every group")
        del again
    os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    # a plan-layout winner is quantized too (pack_quant='int8'): the quant
    # tolerance holds whenever any pack is, 1e-3 otherwise
    scale = max(float(r.abs().max()) for r in refs)
    qs = sv.quant_stats()
    tol = cfg.n_layers * qs["max_rel_err"] * scale if qs else TOL_LOGITS
    _logit_gap("auto vs dense", outs, refs, tol)
    auto_ms = _serve_times(sv.forward, reqs, batch8)
    print(f"[serving_auto] served winners: {auto_ms[0]:.3f} ms per (1, 384) "
          f"request, {auto_ms[1]:.3f} ms per (8, 384) batch")
    del sv

    # the negative control: every pattern pinned to the masked arm, as
    # prepare_servable pins 'plan_pallas'
    registry = PatternRegistry()
    sp, packs, stats = export_params(
        pruned, cfg, tile=spec.tile, fuse_qkv=True, cross_layer_union=True,
        registry=registry, backend_chooser=pinned_chooser("masked"),
        device=dev)
    ctrl = Servable(sp, cfg, dataclasses.replace(
        spec, prune="none", pack_quant="none"), packs, registry, dev,
        export_stats=stats)
    ctrl.forward(reqs[0])
    torch.cuda.synchronize()
    per_forward = 4 * cfg.n_layers
    # --- the counted main-path run: every count set to 0 just before
    for fn in counters.values():
        fn.launches = 0
    outs = []
    for toks in reqs + [batch8]:
        before = bm.masked_matmul.launches
        outs.append(ctrl.forward(toks))
        check(bm.masked_matmul.launches - before == per_forward,
              f"K7 launched {bm.masked_matmul.launches - before} times in "
              f"one forward, expected {per_forward}")
    torch.cuda.synchronize()
    paths["negative_control"] = {n: fn.launches for n, fn in
                                 counters.items()}
    print(f"[negative_control] launches {paths['negative_control']} "
          f"({per_forward} K7 per forward)")
    _logit_gap("masked (K7) vs dense", outs, refs, TOL_LOGITS)
    k1 = prepare_servable(params, cfg, ServingSpec(
        backend="plan_pallas", **BERT_SPEC), device=dev)
    targets = [lp[g][p]["w"] for lp in pruned["layers"]
               for g, p in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                            ("attn", "wo"), ("ffn", "wi"), ("ffn", "wo"))]
    dense_bytes = sum(t.numel() * t.element_size() for t in targets)
    rows = [("masked (K7)", ctrl.forward, ctrl.pack_bytes()[0]),
            ("BSR (K1)", k1.forward, k1.pack_bytes()[0]),
            ("dense", dense, dense_bytes)]
    for name, fn, nbytes in rows:
        ms = _serve_times(fn, reqs, batch8)
        print(f"[negative_control] {name:12s} {ms[0]:.3f} ms per (1, 384) "
              f"request, {ms[1]:.3f} ms per (8, 384) batch, projection "
              f"weights {nbytes / 2**20:.1f} MiB on the card")
    return paths


# --------------------------------------------------------------------------
# phase 5: sparse BERT-base training -- dense steps with gradual block
# pruning, hand-off to the packed layout, packed fine-tuning through K1, K4
# and K5
# --------------------------------------------------------------------------

TRAIN_STEPS = 12
PACKED_STEPS = 4
# The first packed step through the kernels against the same step through
# the plain plan composition on the card (same params, same batch): both
# accumulate in fp32 and differ only in summation order, through 12 layers
# forward and back and the 48 packed products. Bar: 1e-4 relative on the
# loss and on the gradient norm.
TOL_PACKED_STEP = 1e-4


def _plan_blocks(plan, dev):
    """The (block row, block column) of each real tile of a plan, in
    ``unpack_plan_data``'s order."""
    import numpy as np
    import torch
    rows = plan.row_of_vrow[plan.vrow].astype(np.int64)
    cols = plan.col_idx[plan.vrow, plan.slot].astype(np.int64)
    return torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)


def _plan_dense(plan, vals):
    """The dense (N, K) weight one packed projection's values stand for."""
    from repro_torch.kernels.exec_plan import unpack_plan_data
    (n, k), (bn, bk) = plan.shape, plan.tile
    blocks = vals.new_zeros((n // bn, k // bk, bn, bk))
    blocks[_plan_blocks(plan, vals.device)] = unpack_plan_data(plan, vals)
    return blocks.permute(0, 2, 1, 3).reshape(n, k)


def _unpacked_dense(params, packs, cfg):
    """The dense weights the packed values stand for: every packed
    projection scattered back to (N, K) -- per period for an LM's stacked
    ``blocks`` -- and a fused QKV split into wq/wk/wv."""
    import torch
    section = "layers" if "layers" in params else "blocks"
    layers = [{g: dict(v) for g, v in lp.items()} for lp in params[section]]
    for key, pk in packs.items():
        _, i, group, name = key.split("/")
        vals = layers[int(i)][group][name]["w"]
        w = (_plan_dense(pk.plan, vals) if section == "layers" else
             torch.stack([_plan_dense(pk.plan, v) for v in vals]))
        if name == "wqkv":
            del layers[int(i)][group][name]
            dq, dkv = cfg.q_dim, cfg.kv_dim
            for proj, (a, b) in (("wq", (0, dq)), ("wk", (dq, dq + dkv)),
                                 ("wv", (dq + dkv, dq + 2 * dkv))):
                layers[int(i)][group][proj] = {"w": w[..., a:b, :]}
        else:
            layers[int(i)][group][name] = {"w": w}
    out = dict(params)
    out[section] = tuple(layers)
    return out


def phase_training(seed: int):
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pruner import sparsity_report
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.kernels import bsr_matmul as bm
    from repro_torch.kernels import plan_dds
    from repro_torch.kernels.exec_plan import plan_schedule
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.models.api import model_forward
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.fault_tolerance import (FaultInjector,
                                                     FaultToleranceConfig)
    from repro_torch.serving import ServingSpec, prepare_servable
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sp = SparsityConfig(block_shape=(128, 128), sparsity=0.8,
                        lambda_reg=1e-4, start_step=2, end_step=8)
    cfg = dataclasses.replace(get_config("bert_base"), sparsity=sp)
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size)
          == (12, 768, 3072, 30522), "not BERT-base at full width")
    dcfg = DataConfig(seq_len=384, global_batch=8, vocab_size=30522)
    opt = AdamWConfig(peak_lr=1e-4, warmup_steps=2, total_steps=TRAIN_STEPS,
                      weight_decay=0.01)
    counters = {"plan_dds": plan_dds, "dds": bm.dds, "dds_t": bm.dds_t,
                "plan_dds_t": bm.plan_dds_t, "sddmm": bm.sddmm,
                "plan_sddmm": bm.plan_sddmm}
    # --- the counted main-path run: every count set to 0 just before
    for fn in counters.values():
        fn.launches = 0

    # 1. dense training with gradual block pruning, one injected fault
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(n_steps=TRAIN_STEPS, ckpt_dir=tmp, seed=seed,
                           log_every=1, opt=opt, prune=True,
                           ft=FaultToleranceConfig(checkpoint_every=4))
        inj = FaultInjector(fail_at_steps=(6,))
        tr = Trainer(cfg, tcfg, device=dev, data_cfg=dcfg,
                     fault_injector=inj)
        times = []
        one_step = tr._one_step

        def timed(state, step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = one_step(state, step)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out
        tr._one_step = timed
        t0 = time.perf_counter()
        state, hist = tr.fit(resume=False)
        wall = time.perf_counter() - t0
        restarts = tr.supervisor.restarts
    losses = [loss for _, loss in hist]
    print(f"[training] {cfg.arch} dense: {len(hist)} steps run for "
          f"{TRAIN_STEPS} (fault at step 6, restart from the step-4 "
          f"checkpoint), wall {wall:.2f} s; loss by step "
          f"{[(s, round(loss, 4)) for s, loss in hist]}")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(restarts == 1, f"Supervisor.restarts = {restarts}, expected 1")
    check(inj.fired == {6}, f"injected faults fired at {inj.fired}")
    check(int(state["opt"]["step"]) == TRAIN_STEPS,
          f"optimizer step {int(state['opt']['step'])}")
    print(f"[training] dense Trainer ms per step over {len(times)} steps "
          f"(host clock, synchronized; includes the batch and the mask "
          f"update): median {1e3 * np.median(times):.3f}, min "
          f"{1e3 * min(times):.3f}, max {1e3 * max(times):.3f}")
    report = sparsity_report(state["params"], sp)
    check(len(report) == 4 * cfg.n_layers, f"report covers {len(report)}")
    low = min(report.values())
    print(f"[training] block sparsity of the {len(report)} targeted weights "
          f"after step {TRAIN_STEPS - 1}: min {low:.4f}, max "
          f"{max(report.values()):.4f} (target {sp.sparsity})")
    check(low >= sp.sparsity, f"targeted weights only {low:.4f} sparse")

    # 2. hand-off to the packed serving layout (examples/train_lm_sparse.py)
    spec = ServingSpec(tile=(128, 128), prune="none", fuse_qkv=True,
                       cross_layer_union=True, backend="plan_pallas")
    servable = prepare_servable(state["params"], cfg, spec, device=dev)
    packs = servable.packs
    n_packed = len(packs)
    check(n_packed == 4 * cfg.n_layers, f"{n_packed} packed projections")
    st = servable.stats()
    print(f"[training] hand-off: {n_packed} packed projections, "
          f"{st['unique_patterns']} unique patterns, density "
          f"{st['density']:.3f}")
    del state, tr

    # 3. packed fine-tuning: K1 forward, K4 for dX, K5 for the values' grad
    params = servable.params
    opt_state = init_opt_state(params, opt)
    step_fn = make_train_step(cfg, opt, packs=packs)
    pipe = DataPipeline(dcfg)
    batches = [{k: torch.from_numpy(v).to(dev, torch.int64)
                for k, v in pipe.batch_at(TRAIN_STEPS + i).items()}
               for i in range(PACKED_STEPS)]
    pipe.close()

    # the first step through the plain plan composition, for comparison
    plain_step = make_train_step(cfg, opt,
                                 packs={k: v.plan for k, v in packs.items()})
    before = {n: fn.launches for n, fn in counters.items()}
    _, _, m_plain = plain_step(params, opt_state, batches[0])
    torch.cuda.synchronize()
    check(all(fn.launches == before[n] for n, fn in counters.items()),
          "the plain plan composition launched a kernel")

    ms, first = [], None
    for i, batch in enumerate(batches):
        before = {n: fn.launches for n, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        got = {n: fn.launches - before[n] for n, fn in counters.items()}
        want = {"plan_dds": n_packed, "dds": 0, "dds_t": 0,
                "plan_dds_t": n_packed, "sddmm": 0, "plan_sddmm": n_packed}
        check(got == want, f"packed step {i}: launches {got}, expected "
              f"{want} (one K1, K4 and K5 per packed projection)")
        check(np.isfinite(loss), f"packed step {i}: loss {loss}")
        if first is None:
            first = metrics
        print(f"[training] packed step {i}: loss {loss:.6f}, grad_norm "
              f"{float(metrics['grad_norm']):.6f}, {ms[-1]:.3f} ms, "
              f"launches {got}")
    for name in ("loss", "grad_norm"):
        a, b = float(first[name]), float(m_plain[name])
        rel = abs(a - b) / max(abs(b), 1e-30)
        print(f"[training] first packed step {name}: kernels {a:.7f}, "
              f"plain composition {b:.7f}, rel diff {rel:.3e} (tol "
              f"{TOL_PACKED_STEP})")
        check(rel <= TOL_PACKED_STEP, f"packed step {name} differs from "
              f"the plain composition")
    print(f"[training] packed ms per step over {len(ms)} steps (host clock, "
          f"synchronized): median {np.median(ms):.3f}, min {min(ms):.3f}, "
          f"max {max(ms):.3f}")

    dead = 0
    for key, pk in packs.items():
        _, i, group, name = key.split("/")
        vals = params["layers"][int(i)][group][name]["w"]
        mask = torch.from_numpy(~pk.plan.slot_mask).to(dev)
        pad = vals[mask]
        dead += pad.numel()
        check(bool((pad == 0).all()), f"{key}: a padding slot became live")
    print(f"[training] padding slots after {PACKED_STEPS} packed steps: "
          f"{dead} values, all exactly 0")

    tuned = type(servable)(params, cfg, spec, packs, servable.registry, dev)
    dense = _unpacked_dense(params, packs, cfg)
    rng = np.random.RandomState(seed + 4)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 384))).to(dev)
    y = tuned.forward(toks)
    with torch.no_grad():
        y_dense = model_forward(dense, cfg, {"tokens": toks})[0]
    torch.cuda.synchronize()
    err = float((y - y_dense).abs().max())
    print(f"[training] fine-tuned packed forward (1, 384) vs the dense "
          f"forward of the unpacked weights: max |d logits| = {err:.3e} "
          f"(tol {TOL_LOGITS})")
    check(bool(torch.isfinite(y).all()) and err <= TOL_LOGITS,
          "fine-tuned packed forward disagrees with the dense forward")

    state_box = {"p": params, "o": opt_state}

    def packed_step():
        state_box["p"], state_box["o"], _ = step_fn(
            state_box["p"], state_box["o"], batches[0])
    rows = _profile("packed train step (8, 384)", packed_step, top=12)
    # the packed products of one pass (each of K1, K4, K5 does this many):
    # 2 * M * stored values over the 48 packs
    m = batches[0]["tokens"].numel()
    flops = sum(2 * m * pk.plan.real_nnzt * pk.plan.tile[0] * pk.plan.tile[1]
                for pk in packs.values())
    print(f"[training] packed products per pass (M={m}): "
          f"{flops / 1e12:.4f} TFLOP")
    k5 = {}
    for pk in packs.values():
        tiles = plan_schedule(pk.plan).n_tiles
        inst = bm.sddmm_instance(m, pk.plan.tile, torch.float32)
        splits = (bm.sddmm_splits(m, tiles, pk.plan.tile)[0]
                  if inst == "ring" else 1)
        key = f"{pk.plan.shape} [{inst} S={splits}]"
        k5[key] = k5.get(key, 0) + 1
    print(f"[training] K5 instance and splits by projection: {k5}")
    k4 = {}
    for pk in packs.values():
        tile = pk.plan.tile
        inst = bm.dds_instance(m, tile, torch.float32, True)
        if inst == "ring":
            n_cols = pk.plan.shape[1] // tile[1]       # dX's output blocks
            inst += f" {bm.dds_block_rows(m, n_cols, tile[1])} rows"
        key = f"{pk.plan.shape} [{inst}]"
        k4[key] = k4.get(key, 0) + 1
    print(f"[training] K4 instance and block rows by projection: {k4}")
    # device time by kernel name: K1 is plan_dds_common.cuh's plain-value
    # instances, K4 csrc/dds.cu's dds_kernel (general) and dds_ring_kernel,
    # K5 csrc/sddmm.cu's kernels (ring, combine, general)
    for kname, match in (
            ("K1", lambda key: "plan_dds_" in key and "PlainValues" in key),
            ("K4", lambda key: "::dds_kernel" in key
             or "::dds_ring_kernel" in key),
            ("K5", lambda key: "sddmm_" in key)):
        dev_ms = sum(r[0] for r in rows if match(r[2]))
        if dev_ms > 0:
            print(f"[training] {kname} in the packed step: {dev_ms:.3f} ms "
                  f"device, {flops / (dev_ms * 1e-3) / 1e12:.2f} TFLOP/s "
                  f"({flops / (dev_ms * 1e-3) / FP32_FLOP_PER_S:.3f} of the "
                  f"fp32 peak)")
    if rows:
        by_inst = {i: sum(r[1] for r in rows if f"::{k}<" in r[2])
                   for i, k in (("ring", "dds_ring_kernel"),
                                ("general", "dds_kernel"))}
        print(f"[training] K4 launches in the profiled packed step by "
              f"instance: {by_inst}")
        check(by_inst == {"ring": n_packed, "general": 0},
              f"K4 in the packed step: {by_inst}, expected {n_packed} "
              f"ring launches")
    n_params = sum(v.numel() for v in leaves(params))
    print(f"[training] packed params {n_params}; device memory peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {n: fn.launches for n, fn in counters.items()}


# --------------------------------------------------------------------------
# phase 4: gemma3_4b continuous-batching decode through K1, K2 and K3
# --------------------------------------------------------------------------

LM_PROMPTS = (37, 300, 700, 1100, 300, 37)
LM_NEW_TOKENS = 32
# decode_step logits with the flash kernels against the plain
# decode_attention composition on the same bf16 cache: the composition
# rounds the probabilities to bf16 before the value product and the kernels
# keep them fp32, so each attention output differs by about one bf16
# rounding step (2^-8 relative) and 34 residual layers carry that to the
# logits. Bar: 5% of max|logits|.
TOL_FLASH_VS_XLA = 5e-2


def _lm_config():
    from repro_torch.configs import get_config
    cfg = get_config("gemma3_4b")
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
           cfg.vocab_size, cfg.n_layers) == (2560, 8, 4, 256, 10240, 262144,
                                             34),
          "not gemma3_4b at full width and depth")
    return cfg


def _layer_counts(cfg):
    prefix, pattern, n_periods, suffix = cfg.layer_plan()
    kinds = list(prefix) + list(pattern) * n_periods + list(suffix)
    n_global = sum(1 for k in kinds if k.window == 0)
    return len(kinds), n_global, len(kinds) - n_global


def phase_lm_serving(seed: int):
    import numpy as np
    import torch
    from repro_torch.kernels import plan_dds
    from repro_torch.kernels.flash_decode import (decode_kernel_override,
                                                  flash_decode,
                                                  paged_flash_decode)
    from repro_torch.models import api as model_api
    from repro_torch.models.api import init_model
    from repro_torch.serving import ServingSpec, prepare_servable
    dev = torch.device("cuda")
    cfg = _lm_config()
    n_layers, n_global, n_local = _layer_counts(cfg)
    windows = sorted({k.window for k in cfg.pattern if k.window})
    print(f"[lm_serving] {cfg.arch}: {n_layers} layers ({n_local} local, "
          f"window {windows}; {n_global} global), d={cfg.d_model}, "
          f"{cfg.n_heads} query / {cfg.n_kv_heads} KV heads of "
          f"{cfg.head_dim}, d_ff={cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}")
    spec = ServingSpec(tile=(128, 128), sparsity=0.8, prune="tied",
                       fuse_qkv=True, backend="plan_pallas",
                       decode_kernel="flash")
    t0 = time.perf_counter()
    params = init_model(seed, cfg, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    servable = prepare_servable(params, cfg, spec, device=dev)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    st = servable.stats()
    print(f"[lm_serving] init {t_init:.1f} s, prune + export "
          f"{time.perf_counter() - t0 - t_init:.1f} s; "
          f"{st['packed_projections']} packed projections, "
          f"{st['unique_patterns']} unique patterns, density "
          f"{st['density']:.3f}, registry {st['registry']}; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # every packed projection of a layer is one K1 launch a forward
    k1_per_pass = sum(
        cfg.layer_plan()[2] if k.startswith("blocks/") else 1
        for k in servable.packs)
    print(f"[lm_serving] K1 launches per decode step and per prefill: "
          f"{k1_per_pass} (fused QKV, attn wo, ffn wi and wo of every "
          f"layer; ffn/wg is not a prune target of the spec, so it stays a "
          f"dense matmul)")

    rng = np.random.RandomState(seed + 2)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in LM_PROMPTS]
    results, stats = {}, {}
    counts = {"plan_dds": 0, "flash_decode": 0, "paged_flash_decode": 0}
    for layout in ("dense", "paged"):
        eng = servable.engine(max_slots=4, cache_len=1280, sync_every=8,
                              kv_layout=layout)
        check(eng.kv_layout == layout, f"engine fell back from {layout}")
        # warm-up: one short request (library loads, cuBLAS handles)
        eng.submit(prompts[0][:8], max_new_tokens=2)
        eng.run()
        eng.stats = type(eng.stats)()
        torch.cuda.synchronize()
        # --- the counted main-path run: every count set to 0 just before
        plan_dds.launches = 0
        flash_decode.launches = 0
        paged_flash_decode.launches = 0
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_new_tokens=LM_NEW_TOKENS)
                   for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"plan_dds": plan_dds.launches,
               "flash_decode": flash_decode.launches,
               "paged_flash_decode": paged_flash_decode.launches}
        for k, v in got.items():
            counts[k] += v
        es = eng.stats
        for h in handles:
            check(h.status == "done", f"{layout}: request {h.req_id} ended "
                  f"{h.status} ({h.failure})")
            check(len(h.tokens) == LM_NEW_TOKENS, f"{layout}: request "
                  f"{h.req_id} has {len(h.tokens)} tokens")
        steps = es.steps
        want = {"plan_dds": k1_per_pass * (steps + es.prefills),
                "flash_decode": steps * (n_layers if layout == "dense"
                                         else n_local),
                "paged_flash_decode": steps * (0 if layout == "dense"
                                               else n_global)}
        print(f"[lm_serving] {layout}: {len(handles)} requests done, "
              f"{es.tokens_generated} tokens, {steps} decode steps in "
              f"{es.windows} windows, {es.prefills} prefills "
              f"(buckets {dict(es.bucket_hits)}), mean occupancy "
              f"{es.mean_occupancy:.2f}")
        print(f"[lm_serving] {layout}: launches {got} (expected {want})")
        check(got == want, f"{layout}: kernel launch counts {got} differ "
              f"from the layer routing {want}")
        decode_tokens = es.tokens_generated - es.prefills
        print(f"[lm_serving] {layout}: wall {wall:.3f} s; prefill "
              f"{es.prefill_s:.3f} s, decode {es.decode_s:.3f} s, sync "
              f"{es.sync_s:.3f} s; {1e3 * es.decode_s / steps:.3f} ms per "
              f"decode step, {decode_tokens / es.decode_s:.1f} decode "
              f"tokens/s, {es.tokens_generated / wall:.1f} tokens/s end to "
              f"end (host clock, synchronized per window)")
        results[layout] = [list(h.tokens) for h in handles]
        stats[layout] = {"steps": steps, "wall_s": wall,
                         "decode_s": es.decode_s,
                         "ms_per_step": 1e3 * es.decode_s / steps,
                         "launches": got}
        print(f"[lm_serving] {layout}: kv {eng.kv_stats()}")

        # one fused window over four live slots, under the profiler
        prof_eng = servable.engine(max_slots=4, cache_len=1280,
                                   sync_every=8, kv_layout=layout)
        for p in prompts[:4]:
            prof_eng.submit(p, max_new_tokens=LM_NEW_TOKENS)
        prof_eng._schedule()
        live = [s for s in range(4) if prof_eng._pos[s] >= 0]
        check(len(live) == 4, f"{layout}: profiler setup has {live} live")

        def window(e=prof_eng):
            e.servable.decode_many(
                e.cache, e._dev(e._tokens), e._dev(e._pos), 8,
                remaining=e._dev(e._remaining), eos_id=e._dev(e._eos))
        window()
        label = f"{layout} decode window (8 steps, 4 slots)"
        _kernel_share(label, _profile(label, window, top=14))
        del prof_eng, eng

    agree = sum(a == b for ra, rb in zip(results["dense"], results["paged"])
                for a, b in zip(ra, rb))
    total = sum(len(r) for r in results["dense"])
    first = [next((i for i, (a, b) in enumerate(zip(ra, rb)) if a != b),
                  None) for ra, rb in zip(results["dense"],
                                          results["paged"])]
    print(f"[lm_serving] greedy tokens, dense vs paged layout: {agree} of "
          f"{total} equal; first difference per request: {first}")

    # decode_step with the flash kernels against the plain composition on
    # the same cache (four prefilled slots at ragged positions)
    cache, tok, pos, _ = _prefill_slots(servable, prompts[:4])
    with torch.no_grad():
        with decode_kernel_override("flash"):
            before = flash_decode.launches
            y_flash, _ = model_api.decode_step(servable.params, cache, cfg,
                                               tok, pos, packs=servable.packs)
            check(flash_decode.launches - before == n_layers,
                  "the flash decode_step did not run K2 on every layer")
        with decode_kernel_override("xla"):
            before = flash_decode.launches
            y_xla, _ = model_api.decode_step(servable.params, cache, cfg,
                                             tok, pos, packs=servable.packs)
            check(flash_decode.launches == before,
                  "the xla decode_step launched K2")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y_flash).all() and torch.isfinite(y_xla).all()),
          "non-finite decode logits")
    err = float((y_flash - y_xla).abs().max())
    scale = float(y_xla.abs().max())
    same = int((y_flash.argmax(-1) == y_xla.argmax(-1)).sum())
    print(f"[lm_serving] decode_step logits, flash vs xla on the same cache: "
          f"max|d|={err:.4e}, max|logits|={scale:.4e}, tol "
          f"{TOL_FLASH_VS_XLA * scale:.4e}; greedy tokens equal in "
          f"{same} of 4 slots")
    check(err <= TOL_FLASH_VS_XLA * scale,
          "decode_step logits with the flash kernels disagree with xla")
    return counts, servable, results["dense"]


def _prefill_slots(servable, prompts):
    """A 4-slot decode cache with each prompt prefilled into its slot
    (one-shot, as the engine admits), the greedy next tokens, the slots'
    positions and each prompt's last-position logits row."""
    import numpy as np
    import torch
    dev = servable.device
    cache = servable.init_cache(4, 1280)
    sub = servable.init_cache(1, 1280)
    toks, posl, rows = [], [], []
    for slot, p in enumerate(prompts):
        bucket = min(1280, 1 << (len(p) - 1).bit_length())
        padded = np.zeros((bucket,), np.int32)
        padded[:len(p)] = p
        sub, logits = servable.engine_prefill(
            sub, torch.from_numpy(padded).to(dev), len(p))
        servable.engine_write_slot(cache, slot, sub)
        rows.append(logits[len(p) - 1].float())
        toks.append(int(torch.argmax(rows[-1])))
        posl.append(len(p))
    tok = torch.tensor(toks, dtype=torch.int32, device=dev)[:, None]
    pos = torch.tensor(posl, dtype=torch.int32, device=dev)
    return cache, tok, pos, rows


# the int8-pack decode_step logits against the bf16-pack servable's on the
# same prompts: the bar of the flash-vs-xla check, 5% of max|logits|
TOL_QUANT_DECODE = 5e-2


def phase_lm_serving_quant(seed: int, fp=None, fp_tokens=None):
    """gemma3_4b at full width and depth with backend 'plan_pallas',
    pack_quant 'int8' and the flash decode kernels, through the engine of
    the lm_serving phase in the dense KV layout with the same 6 requests:
    every request done, K6 launches per decode step equal to the
    unquantized run's K1 count and no K1, the engine's 'quant' stats, ms per
    decode step and tokens/s; decode_step logits against the bf16-pack
    servable, and greedy-token agreement with the unquantized run."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels import plan_dds, plan_dds_q
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models.api import init_model
    from repro_torch.serving import ServingSpec, prepare_servable
    dev = torch.device("cuda")
    cfg = _lm_config()
    n_layers, _, _ = _layer_counts(cfg)
    spec = ServingSpec(tile=(128, 128), sparsity=0.8, prune="tied",
                       fuse_qkv=True, backend="plan_pallas",
                       decode_kernel="flash")
    params = init_model(seed, cfg, device=dev)
    if fp is None:
        fp = prepare_servable(params, cfg, spec, device=dev)
    t0 = time.perf_counter()
    sv = prepare_servable(params, cfg, dataclasses.replace(
        spec, pack_quant="int8"), device=dev)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    qs = sv.quant_stats()
    print(f"[lm_serving_quant] prune + export + int8 quantization "
          f"{time.perf_counter() - t0:.1f} s; quant_stats {json.dumps(qs)}")
    def per_pass(packs):
        return sum(cfg.layer_plan()[2] if k.startswith("blocks/") else 1
                   for k in packs)
    k6_per_pass = per_pass(sv.packs)
    check(k6_per_pass == per_pass(fp.packs), "the int8 servable packs "
          "other projections than the bf16 one")
    rng = np.random.RandomState(seed + 2)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in LM_PROMPTS]
    eng = sv.engine(max_slots=4, cache_len=1280, sync_every=8,
                    kv_layout="dense")
    eng.submit(prompts[0][:8], max_new_tokens=2)
    eng.run()
    eng.stats = type(eng.stats)()
    torch.cuda.synchronize()
    # --- the counted main-path run: every count set to 0 just before
    plan_dds.launches = 0
    plan_dds_q.launches = 0
    flash_decode.launches = 0
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=LM_NEW_TOKENS) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {"plan_dds": plan_dds.launches, "plan_dds_q": plan_dds_q.launches,
           "flash_decode": flash_decode.launches}
    es = eng.stats
    for h in handles:
        check(h.status == "done" and len(h.tokens) == LM_NEW_TOKENS,
              f"request {h.req_id} ended {h.status} with {len(h.tokens)} "
              f"tokens")
    want = {"plan_dds": 0, "plan_dds_q": k6_per_pass * (es.steps
                                                        + es.prefills),
            "flash_decode": es.steps * n_layers}
    print(f"[lm_serving_quant] {len(handles)} requests done, "
          f"{es.tokens_generated} tokens, {es.steps} decode steps, "
          f"{es.prefills} prefills; launches {got} (expected {want}: "
          f"{k6_per_pass} K6 per decode step and per prefill)")
    check(got == want, f"launch counts {got} differ from {want}")
    sd = eng.stats_dict()
    check("quant" in sd and sd["quant"]["pack_quant"] == "int8",
          "stats_dict() has no 'quant' section")
    decode_tokens = es.tokens_generated - es.prefills
    print(f"[lm_serving_quant] wall {wall:.3f} s; prefill {es.prefill_s:.3f}"
          f" s, decode {es.decode_s:.3f} s; {1e3 * es.decode_s / es.steps:.3f}"
          f" ms per decode step, {decode_tokens / es.decode_s:.1f} decode "
          f"tokens/s, {es.tokens_generated / wall:.1f} tokens/s end to end")
    tokens = [list(h.tokens) for h in handles]
    del eng
    # one fused window over four live slots, under the profiler
    prof_eng = sv.engine(max_slots=4, cache_len=1280, sync_every=8,
                         kv_layout="dense")
    for p in prompts[:4]:
        prof_eng.submit(p, max_new_tokens=LM_NEW_TOKENS)
    prof_eng._schedule()

    def window(e=prof_eng):
        e.servable.decode_many(
            e.cache, e._dev(e._tokens), e._dev(e._pos), 8,
            remaining=e._dev(e._remaining), eos_id=e._dev(e._eos))
    window()
    label = "int8 decode window (8 steps, 4 slots)"
    _kernel_share(label, _profile(label, window, top=14))
    del prof_eng
    if fp_tokens is None:
        e32 = fp.engine(max_slots=4, cache_len=1280, sync_every=8,
                        kv_layout="dense")
        hs = [e32.submit(p, max_new_tokens=LM_NEW_TOKENS) for p in prompts]
        e32.run()
        fp_tokens = [list(h.tokens) for h in hs]
        del e32
    agree = sum(a == b for ra, rb in zip(tokens, fp_tokens)
                for a, b in zip(ra, rb))
    total = sum(len(r) for r in fp_tokens)
    print(f"[lm_serving_quant] greedy tokens equal to the bf16-pack run: "
          f"{agree} of {total} ({agree / total:.3f}; random full-width "
          f"weights make near-ties, so this is printed, not gated)")
    outs = []
    for s_ in (sv, fp):
        cache, tok, pos, _ = _prefill_slots(s_, prompts[:4])
        logits, _ = s_.decode_step(cache, tok, pos)
        outs.append(logits)
        del cache
    torch.cuda.synchronize()
    err = float((outs[0] - outs[1]).abs().max())
    scale = float(outs[1].abs().max())
    print(f"[lm_serving_quant] decode_step logits, int8 vs bf16 packs: "
          f"max|d|={err:.4e}, max|logits|={scale:.4e}, tol "
          f"{TOL_QUANT_DECODE * scale:.4e}")
    check(bool(torch.isfinite(outs[0]).all()) and
          err <= TOL_QUANT_DECODE * scale,
          "int8-pack decode logits disagree with the bf16 packs")
    return got


# --------------------------------------------------------------------------
# phase 4b: the rest of the engine (SLO scheduling with chunked prefill,
# sampling, int8 KV, chaos and the watchdog) on gemma3_4b
# --------------------------------------------------------------------------

# chunked prefill as a deployment turns it on: 256-token chunks, a budget of
# 2048 prefill tokens a window, decode tokens reserved first
SCHED_CHUNK = 256
SCHED_BUDGET = 2048
# index of the 1100-token prompt in LM_PROMPTS, submitted after two windows
LONG = 3
# the int8-KV decode_step logits against the bf16-KV cache's; and the
# chunked-prefill caches' against the one-shot caches': the bar of the
# flash-vs-xla check, 5% of max|logits|
TOL_KV_DECODE = 5e-2
SAMPLING = dict(temperature=0.8, top_k=64, seed=1234)


def _chunk_prefill_slots(servable, prompts, k1_per_pass):
    """The caches of ``_prefill_slots`` written chunk by chunk as the
    engine's scheduler does (``_chunk_len`` tokens from position 0, each
    chunk bucketed) through ``suffix_prefill``; every chunk is checked to
    launch one K1 per packed projection and no K2 / K3. Returns (cache,
    last-position logits rows, the chunk Ms)."""
    import numpy as np
    import torch
    from repro_torch.kernels import plan_dds
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)
    dev = servable.device
    cache = servable.init_cache(4, 1280)
    rows, ms = [], []
    for slot, p in enumerate(prompts):
        for start in range(0, len(p), SCHED_CHUNK):
            c = min(SCHED_CHUNK, len(p) - start)
            bucket = max(8, 1 << (c - 1).bit_length())
            toks = np.zeros((bucket,), np.int32)
            toks[:c] = p[start:start + c]
            before = (plan_dds.launches, flash_decode.launches,
                      paged_flash_decode.launches)
            cache, logits = servable.suffix_prefill(
                cache, torch.from_numpy(toks).to(dev), slot, start, c)
            got = (plan_dds.launches - before[0],
                   flash_decode.launches - before[1],
                   paged_flash_decode.launches - before[2])
            check(got == (k1_per_pass, 0, 0), f"a chunk of {c} tokens "
                  f"launched K1/K2/K3 {got}, not ({k1_per_pass}, 0, 0)")
            ms.append(bucket)
        rows.append(logits[c - 1].float())
    return cache, rows, ms


def _drive_staggered(eng, prompts, n_new):
    """``lm_serving``'s traffic with the long prompt held back: every other
    prompt at once, the long one after two decode windows. Returns the
    handles (in LM_PROMPTS order) and the longest host-clock gap between two
    decode windows while the long prompt waited for its first token."""
    import torch
    first = [p for i, p in enumerate(prompts) if i != LONG]
    hs = [eng.submit(p, max_new_tokens=n_new) for p in first]
    ends = []

    def step():
        w = eng.stats.windows
        more = eng.step()
        if eng.stats.windows > w:
            torch.cuda.synchronize()
            ends.append(time.monotonic())
        return more
    while eng.stats.windows < 2 and step():
        pass
    t_sub = time.monotonic()
    long_h = eng.submit(prompts[LONG], max_new_tokens=n_new)
    while step():
        pass
    t_first = long_h.first_token_at
    gaps = [b - a for a, b in zip(ends, ends[1:])
            if b > t_sub and a < t_first]
    hs.insert(LONG, long_h)
    return hs, max(gaps) if gaps else float("nan")


def _margin_check(name, one_rows, chunk_rows):
    """First tokens of one-shot against chunked prefill logits: printed; a
    differing argmax fails only where the one-shot top-2 margin is at least
    twice the two rows' max |difference| (elsewhere the rows are a near
    tie)."""
    import torch
    for i, (a, b) in enumerate(zip(one_rows, chunk_rows)):
        d = float((a - b).abs().max())
        top2 = torch.topk(a, 2).values
        margin = float(top2[0] - top2[1])
        same = int(a.argmax()) == int(b.argmax())
        print(f"[lm_serving_sched] {name} prompt {i}: first token "
              f"{'equal' if same else 'differs'}, max|d logits| {d:.4e}, "
              f"one-shot top-2 margin {margin:.4e}")
        check(same or margin < 2 * d, f"{name} prompt {i}: the chunked "
              f"prefill's first token differs where the one-shot margin "
              f"{margin:.4e} is >= 2 x {d:.4e}")


def phase_lm_serving_sched(seed: int, card: str, servable=None):
    """gemma3_4b at full width and depth (bf16 packs, the lm_serving
    servable) through the rest of the engine: chunked prefill in the dense
    and the paged layout, SLO fast-fail and overload shedding, temperature
    / top-k sampling, the int8 KV cache, and the chaos sites with the
    watchdog."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels import plan_dds
    from repro_torch.kernels.bsr_matmul import plan_instance
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)
    from repro_torch.models import prng
    from repro_torch.models.sampling import sample_tokens, slot_keys
    from repro_torch.models.api import init_model
    from repro_torch.runtime.chaos import SITE_PREFILL_CHUNK, ChaosInjector
    from repro_torch.serving import (EngineRequest, FailureReason, SchedSpec,
                                     Servable, ServingSpec, prepare_servable)
    cfg = _lm_config()
    n_layers, n_global, n_local = _layer_counts(cfg)
    if servable is None:
        params = init_model(seed, cfg, device="cuda")
        servable = prepare_servable(params, cfg, ServingSpec(
            tile=(128, 128), sparsity=0.8, prune="tied", fuse_qkv=True,
            backend="plan_pallas", decode_kernel="flash"), device="cuda")
        del params
    k1 = sum(cfg.layer_plan()[2] if k.startswith("blocks/") else 1
             for k in servable.packs)
    rng = np.random.RandomState(seed + 2)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in LM_PROMPTS]
    n_oneshot = sum(1 for p in prompts if len(p) <= SCHED_CHUNK)
    sched = SchedSpec(max_chunk=SCHED_CHUNK, token_budget=SCHED_BUDGET,
                      decode_priority=True)
    print(f"[lm_serving_sched] card: {card}; {sched}; prompts {LM_PROMPTS}, "
          f"the {LM_PROMPTS[LONG]}-token one after two windows")
    counts = {"plan_dds": 0, "flash_decode": 0, "paged_flash_decode": 0}
    marks = [time.perf_counter()]

    def part(name):
        marks.append(time.perf_counter())
        print(f"[lm_serving_sched] {name}: {marks[-1] - marks[-2]:.1f} s")

    def zero():
        plan_dds.launches = 0
        flash_decode.launches = 0
        paged_flash_decode.launches = 0

    def read():
        got = {"plan_dds": plan_dds.launches,
               "flash_decode": flash_decode.launches,
               "paged_flash_decode": paged_flash_decode.launches}
        for key, v in got.items():
            counts[key] += v
        return got

    # --- 1. chunked prefill beside one-shot, dense and paged layouts
    tokens = {}
    for layout in ("dense", "paged"):
        runs = {}
        for kind in ("one-shot", "chunked"):
            eng = servable.engine(max_slots=4, cache_len=1280, sync_every=8,
                                  kv_layout=layout,
                                  sched=sched if kind == "chunked" else None)
            check(eng.kv_layout == layout and eng._chunking ==
                  (kind == "chunked"), f"{layout} {kind}: engine set up "
                  f"as {eng.kv_layout}, chunking {eng._chunking}")
            eng.submit(prompts[0][:8], max_new_tokens=2)      # warm-up
            eng.run()
            eng.stats = type(eng.stats)()
            torch.cuda.synchronize()
            zero()              # the counted run: counts 0 just before
            t0 = time.perf_counter()
            hs, gap = _drive_staggered(eng, prompts, LM_NEW_TOKENS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read() if kind == "chunked" else None
            es = eng.stats
            for h in hs:
                check(h.status == "done" and len(h.tokens) == LM_NEW_TOKENS,
                      f"{layout} {kind}: request {h.req_id} ended "
                      f"{h.status} ({h.failure}) with {len(h.tokens)} tokens")
            runs[kind] = [list(h.tokens) for h in hs]
            decode_tokens = es.tokens_generated - es.prefills
            print(f"[lm_serving_sched] {layout} {kind}: {len(hs)} requests "
                  f"done, {es.steps} decode steps in {es.windows} windows, "
                  f"{es.prefills} prefills, {es.prefill_chunks} chunks; "
                  f"{1e3 * es.decode_s / es.steps:.3f} ms per decode step, "
                  f"{decode_tokens / es.decode_s:.1f} decode tokens/s, "
                  f"wall {wall:.3f} s; longest gap between decode windows "
                  f"while the long prompt prefilled {1e3 * gap:.3f} ms "
                  f"(host clock; {card})")
            if kind == "chunked":
                want = {"plan_dds": k1 * (es.steps + n_oneshot
                                          + es.prefill_chunks),
                        "flash_decode": es.steps * (
                            n_layers if layout == "dense" else n_local),
                        "paged_flash_decode": es.steps * (
                            0 if layout == "dense" else n_global)}
                print(f"[lm_serving_sched] {layout} chunked: launches {got} "
                      f"(expected {want}: {k1} K1 a decode step, a one-shot "
                      f"prefill and a chunk)")
                check(got == want, f"{layout} chunked: launch counts {got} "
                      f"differ from the layer routing {want}")
                check(es.prefill_chunks > len(prompts) - n_oneshot,
                      f"{layout}: {es.prefill_chunks} chunks is no "
                      f"multi-chunk prefill")
            if layout == "dense" and kind == "one-shot":
                bf16_kv_bytes = eng.kv_stats()["kv_bytes_total"]
            del eng
        agree = sum(a == b for ra, rb in zip(runs["one-shot"],
                                             runs["chunked"])
                    for a, b in zip(ra, rb))
        print(f"[lm_serving_sched] {layout}: greedy tokens chunked vs "
              f"one-shot {agree} of {len(prompts) * LM_NEW_TOKENS} equal")
        tokens[layout] = runs["chunked"]
    chunk_ms = sorted({max(8, 1 << (min(SCHED_CHUNK, len(p) - s) - 1)
                           .bit_length())
                       for p in prompts if len(p) > SCHED_CHUNK
                       for s in range(0, len(p), SCHED_CHUNK)})
    print(f"[lm_serving_sched] K1 instance by chunk M: "
          f"{ {m: plan_instance(m, (128, 128), torch.bfloat16, torch.bfloat16) for m in chunk_ms} }")

    part("1. chunked beside one-shot, dense and paged")

    # prefill logits and decode_step logits: one-shot against chunked
    for lo in (0, 4):
        group = prompts[lo:lo + 4]
        cache1, tok, pos, rows1 = _prefill_slots(servable, group)
        cache2, rows2, _ = _chunk_prefill_slots(servable, group, k1)
        _margin_check(f"prompts {lo}..{lo + len(group) - 1}", rows1, rows2)
        if lo:
            continue
        y1, _ = servable.decode_step(cache1, tok, pos)
        y2, _ = servable.decode_step(cache2, tok, pos)
        torch.cuda.synchronize()
        err = float((y1 - y2).abs().max())
        scale = float(y1.abs().max())
        print(f"[lm_serving_sched] decode_step logits after chunked vs "
              f"one-shot prefill (prompts {LM_PROMPTS[:4]}): max|d|="
              f"{err:.4e}, max|logits|={scale:.4e}, tol "
              f"{TOL_KV_DECODE * scale:.4e}")
        check(bool(torch.isfinite(y2).all()) and
              err <= TOL_KV_DECODE * scale, "decode_step logits after a "
              "chunked prefill disagree with the one-shot caches'")
        del cache1, cache2

    part("1. prefill and decode_step logits, one-shot against chunked")

    # one chunked window under the profiler: three slots decoding, the long
    # prompt admitted and prefilled chunk by chunk in the same step
    prof = servable.engine(max_slots=4, cache_len=1280, sync_every=8,
                           sched=sched)
    for i in (0, 1, 5):
        prof.submit(prompts[i], max_new_tokens=LM_NEW_TOKENS)
    prof.step()
    prof.submit(prompts[LONG], max_new_tokens=LM_NEW_TOKENS)
    label = (f"chunked window ({LM_PROMPTS[LONG]}-token prompt in "
             f"{SCHED_CHUNK}-token chunks, then 8 decode steps of 4 slots)")
    _kernel_share(label, _profile(label, prof.step, top=14))
    print(f"[lm_serving_sched] (profile on {card})")
    del prof

    part("1. a profiled chunked window")

    # --- 2. SLO: deadline fast-fail and overload shedding. The bound on
    # the queue delay is one request's service time as this card measures
    # it (a warm-up engine's rates), so four queued requests fit and a
    # burst of ten does not
    probe = EngineRequest(req_id=-1, prompt=np.zeros(37, np.int32),
                          max_new_tokens=LM_NEW_TOKENS)
    eng = servable.engine(max_slots=4, cache_len=1280, sync_every=8)
    eng.submit(prompts[0], max_new_tokens=LM_NEW_TOKENS)
    eng.run()
    slo = SchedSpec(fast_fail=True,
                    max_queue_delay_s=round(eng._service_estimate_s(probe),
                                            3))
    eng = servable.engine(max_slots=4, cache_len=1280, sync_every=8,
                          sched=slo)
    warm = eng.submit(prompts[0], max_new_tokens=LM_NEW_TOKENS)
    eng.run()
    check(warm.status == "done", "SLO warm-up request not done")
    expired = eng.submit(prompts[0], max_new_tokens=8, deadline_s=-1.0)
    projected = eng.submit(prompts[5], max_new_tokens=LM_NEW_TOKENS,
                           deadline_s=1e-3)
    for h in (expired, projected):
        check(h.status == "failed" and h.failure.code ==
              FailureReason.DEADLINE, f"request {h.req_id} past its "
              f"deadline ended {h.status} ({h.failure})")
    # the four slots held, one admission a window, by requests of a
    # priority above the burst's (so the burst preempts none)
    blockers = []
    for p in (prompts[0], prompts[5], prompts[0], prompts[5]):
        blockers.append(eng.submit(p, max_new_tokens=2 * LM_NEW_TOKENS,
                                   priority=2))
        eng.step()
    check(all(h.status == "active" for h in blockers),
          f"blockers not active: {[(h.status, h.failure) for h in blockers]}")
    est = eng._service_estimate_s(probe)
    burst = [eng.submit(prompts[5], max_new_tokens=LM_NEW_TOKENS,
                        priority=i % 2) for i in range(10)]
    eng.run()
    shed = [h for h in burst if h.status == "shed"]
    kept = [h for h in burst if h.status != "shed"]
    print(f"[lm_serving_sched] SLO: estimated service {est:.3f} s a request "
          f"(measured rates, {card}); a burst of {len(burst)} beyond "
          f"max_queue_delay_s={slo.max_queue_delay_s}: {len(shed)} shed "
          f"(priorities {[h.priority for h in shed]}), {len(kept)} served "
          f"(priorities {[h.priority for h in kept]}); deadline misses "
          f"{eng.stats.deadline_misses}")
    check(shed and all(h.failure.code == FailureReason.OVERLOAD
                       for h in shed), "the burst was not shed (OVERLOAD)")
    check(max(h.priority for h in shed) <= min(h.priority for h in kept),
          "shedding did not take the lowest priority first")
    for h in [warm] + blockers + kept:
        check(h.status == "done", f"SLO request {h.req_id} ended "
              f"{h.status} ({h.failure})")
    eng.verify_invariants()
    del eng

    part("2. SLO")

    # --- 3. sampling: temperature 0.8, top-k 64, seed 1234, dense
    runs = []
    for _ in range(2):
        eng = servable.engine(max_slots=4, cache_len=1280, sync_every=8,
                              **SAMPLING)
        eng.submit(prompts[0][:8], max_new_tokens=2)          # warm-up
        eng.run()
        eng.stats = type(eng.stats)()
        zero()
        hs = [eng.submit(p, max_new_tokens=LM_NEW_TOKENS) for p in prompts]
        eng.run()
        read()
        for h in hs:
            check(h.status == "done", f"sampled request {h.req_id} ended "
                  f"{h.status} ({h.failure})")
        runs.append([list(h.tokens) for h in hs])
        es = eng.stats
        del eng
    same = sum(a == b for ra, rb in zip(runs[0], tokens["dense"])
               for a, b in zip(ra, rb))
    print(f"[lm_serving_sched] sampling {SAMPLING}: two runs bitwise equal "
          f"{runs[0] == runs[1]}; {same} of {len(prompts) * LM_NEW_TOKENS} "
          f"tokens equal to the greedy run (random full-width weights: "
          f"top-2 logit margins of ~20, so T=0.8 rarely leaves the argmax); "
          f"{1e3 * es.decode_s / es.steps:.3f} ms per decode step ({card})")
    check(runs[0] == runs[1], "two sampled runs gave different tokens")
    key_d = prng.PRNGKey(SAMPLING["seed"], device="cuda")
    key_h = prng.PRNGKey(SAMPLING["seed"])
    pos = torch.arange(-1, 255, dtype=torch.int64).reshape(4, 64)
    keys_d = torch.stack([slot_keys(key_d, pos[:, j].cuda())
                          for j in range(64)]).cpu()
    keys_h = torch.stack([slot_keys(key_h, pos[:, j]) for j in range(64)])
    check(torch.equal(keys_d, keys_h), "threefry keys on the card differ "
          "from the CPU's")
    # the sampler itself on the card against the CPU, on logits flat enough
    # that it draws: 64 rows of gemma3_4b's vocabulary at unit scale
    logits = torch.from_numpy(np.random.RandomState(seed + 5).randn(
        64, cfg.vocab_size).astype(np.float32))
    row_pos = torch.arange(64, dtype=torch.int32) * 17 - 1
    drawn = {}
    for top_k in (0, SAMPLING["top_k"]):
        kw = dict(temperature=SAMPLING["temperature"], top_k=top_k)
        got = sample_tokens(logits.cuda(), key_d, row_pos.cuda(), **kw).cpu()
        want = sample_tokens(logits, key_h, row_pos, **kw)
        check(torch.equal(got, want), f"sampled tokens (top_k={top_k}) on "
              f"the card differ from the CPU's")
        drawn[top_k] = int((got != logits.argmax(-1)).sum())
    print(f"[lm_serving_sched] sampling keys of 4 slots x 64 positions: "
          f"card == CPU bitwise; sample_tokens on 64 unit-scale rows: card "
          f"== CPU, {drawn} rows (by top_k) away from the argmax")

    part("3. sampling")

    # --- 4. int8 KV: dense layout, one-shot
    cfg8 = dataclasses.replace(cfg, kv_cache_quant=True)
    sv8 = Servable(servable.params, cfg8, servable.spec, servable.packs,
                   servable.registry, servable.device)
    eng = sv8.engine(max_slots=4, cache_len=1280, sync_every=8)
    eng.submit(prompts[0][:8], max_new_tokens=2)
    eng.run()
    eng.stats = type(eng.stats)()
    torch.cuda.synchronize()
    zero()
    t0 = time.perf_counter()
    hs = [eng.submit(p, max_new_tokens=LM_NEW_TOKENS) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read()
    es = eng.stats
    for h in hs:
        check(h.status == "done" and len(h.tokens) == LM_NEW_TOKENS,
              f"int8 KV: request {h.req_id} ended {h.status} ({h.failure})")
    want = {"plan_dds": k1 * (es.steps + es.prefills), "flash_decode": 0,
            "paged_flash_decode": 0}
    int8_bytes = eng.kv_stats()["kv_bytes_total"]
    decode_tokens = es.tokens_generated - es.prefills
    print(f"[lm_serving_sched] int8 KV: {len(hs)} requests done, "
          f"{es.steps} decode steps, launches {got} (expected {want}); "
          f"KV cache bytes {int8_bytes} int8 vs {bf16_kv_bytes} bf16 "
          f"({int8_bytes / bf16_kv_bytes:.3f}); "
          f"{1e3 * es.decode_s / es.steps:.3f} ms per decode step, "
          f"{decode_tokens / es.decode_s:.1f} decode tokens/s, wall "
          f"{wall:.3f} s ({card})")
    check(got == want, f"int8 KV: launch counts {got} differ from {want}")
    int8_tokens = [list(h.tokens) for h in hs]
    del eng
    outs = []
    for s_ in (sv8, servable):
        cache, tok, pos, _ = _prefill_slots(s_, prompts[:4])
        logits, _ = s_.decode_step(cache, tok, pos)
        outs.append(logits)
        del cache
    torch.cuda.synchronize()
    err = float((outs[0] - outs[1]).abs().max())
    scale = float(outs[1].abs().max())
    agree = sum(a == b for ra, rb in zip(int8_tokens, tokens["dense"])
                for a, b in zip(ra, rb))
    print(f"[lm_serving_sched] decode_step logits, int8 vs bf16 KV: "
          f"max|d|={err:.4e}, max|logits|={scale:.4e}, tol "
          f"{TOL_KV_DECODE * scale:.4e}; greedy tokens equal to the bf16-KV "
          f"chunked run {agree} of {len(prompts) * LM_NEW_TOKENS}")
    check(bool(torch.isfinite(outs[0]).all()) and
          err <= TOL_KV_DECODE * scale,
          "int8-KV decode logits disagree with the bf16 KV cache's")

    part("4. int8 KV")

    # --- 5. chaos and the watchdog: the 3rd prefill chunk raises
    chaos = ChaosInjector()
    chaos.inject(SITE_PREFILL_CHUNK, at=3, exc=RuntimeError("injected "
                                                           "chunk fault"))
    eng = servable.engine(max_slots=4, cache_len=1280, sync_every=8,
                          sched=sched, chaos=chaos, watchdog_timeout_s=30.0)
    try:
        hs = [eng.submit(prompts[i], max_new_tokens=LM_NEW_TOKENS)
              for i in (2, 1, 0)]       # 700 (3 chunks), 300, 37 tokens
        eng.run()
        wd = eng.stats_dict().get("watchdog")
    finally:
        eng.close()
    print(f"[lm_serving_sched] chaos: {[(h.status, str(h.failure)) for h in hs]}"
          f"; {chaos.count(SITE_PREFILL_CHUNK)} chunk hits; watchdog {wd}")
    check(hs[0].status == "failed" and hs[0].failure.code ==
          FailureReason.PREFILL_ERROR and "injected chunk fault" in
          hs[0].failure.message, "the request of the 3rd chunk did not "
          "fail with its reason")
    check(all(h.status == "done" for h in hs[1:]), "a request the fault "
          "did not target failed")
    check(wd is not None and wd["stalls"] == 0,
          f"stats_dict()['watchdog'] is {wd}, not present with 0 stalls")
    eng.verify_invariants()
    part("5. chaos")
    return counts


# --------------------------------------------------------------------------
# phase 4c: lm_families -- the vlm, MoE and MLA families through the engine
# --------------------------------------------------------------------------

# (model, depth cut or None, the reason printed); one after the other
LM_FAMILIES = (("pixtral_12b", 20,
                "full width, 20 of 40 layers (cut to fit lm_tp_train in "
                "the run's time limit)"),
               ("deepseek_v2_lite_16b", 9,
                "full width, 9 of 27 layers: the dense first layer and 8 "
                "MoE layers (cut to fit lm_tp_train in the run's time "
                "limit)"),
               ("qwen3_moe_235b_a22b", 4,
                "full width, 4 of 94 layers: the whole model (~470 GB "
                "bf16) does not fit the card's 80 GB"))
VLM_TOKENS = 512
# a chunked-prefill request of the MoE gate check: one-shot, as logged
GATE_PROMPTS = (300, 37)


def _family_config(name, n_layers):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    want = {"pixtral_12b": (40, 5120, 32, 8, 128, 131072),
            "deepseek_v2_lite_16b": (27, 2048, 16, 16, 128, 102400),
            "qwen3_moe_235b_a22b": (94, 4096, 64, 4, 128, 151936)}[name]
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.vocab_size) == want,
          f"{name} is not the published configuration")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg


def _plain_packs(packs):
    """The same packs pinned to the plain plan composition (no kernel)."""
    from repro_torch.kernels.exec_plan import PlanChoice
    return {k: PlanChoice(v.plan, "plan") if isinstance(v, PlanChoice)
            else v for k, v in packs.items()}


class _RouterLog:
    """Records every MoE routing call's router logits, top-k indices and
    whole routing (``models.moe.route`` wrapped while a pass runs). With
    ``replay`` (another pass's log, possibly from another process) each
    call returns that pass's routing in its place, so the two passes route
    every token alike."""

    def __init__(self, replay=None):
        from repro_torch.models import moe
        self.moe, self.calls, self.routes = moe, [], []
        self._route = moe.route
        self._replay = replay

    def __enter__(self):
        import torch

        def route(router, x2, cfg):
            out = self._route(router, x2, cfg)
            logits = torch.matmul(x2.float(), router)
            self.calls.append((logits, out[2]))
            self.routes.append(out)
            if self._replay is not None:
                return tuple(r.to(x2.device) for r in
                             self._replay.routes[len(self.calls) - 1])
            return out
        self.moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self._route

    def to_host(self):
        """This log's calls and routes with every tensor on the host, to
        send to another process (``_routing_flips`` reads it, ``replay``
        takes it)."""
        import types
        return types.SimpleNamespace(
            calls=[(a.cpu(), b.cpu()) for a, b in self.calls],
            routes=[tuple(r.cpu() for r in out) for out in self.routes])


def _routing_flips(name, kern, plain, k, what="kernels vs plain"):
    """Tokens whose top-k expert set differs between two passes (the kernel
    and the plain pass; a mesh and one device), layer by layer; a flip
    fails only where the second pass's k-th vs (k+1)-th router logit margin
    is at least twice the layer's max |delta| of the router logits
    (elsewhere a near-tie). ``name`` starts the printed line. Returns the
    flips' margins."""
    import torch
    check(len(kern.calls) == len(plain.calls) > 0,
          f"{name}: routing calls {len(kern.calls)} vs {len(plain.calls)}")
    margins = []
    for (la, ia), (lb, ib) in zip(kern.calls, plain.calls):
        la, ia = la.to(lb.device), ia.to(ib.device)
        d = float((la - lb).abs().max())
        sa, _ = torch.sort(ia, dim=-1)
        sb, _ = torch.sort(ib, dim=-1)
        diff = (sa != sb).any(dim=-1)
        if bool(diff.any()):
            top = torch.sort(lb, dim=-1, descending=True).values
            margin = (top[:, k - 1] - top[:, k])[diff]
            margins += [float(x) for x in margin]
            check(float(margin.max()) < 2 * d, f"{name}: a token's top-{k} "
                  f"experts differ where the router margin "
                  f"{float(margin.max()):.4e} is >= 2 x {d:.4e}")
    n = sum(int(i.shape[0]) for _, i in kern.calls)
    print(f"{name}: top-{k} expert sets differ for {len(margins)} of {n} "
          f"routed tokens ({what}), all at near-ties (largest margin "
          f"{max(margins, default=0.0):.4e})")
    return margins


def _clone_cache(tree):
    """A copy of a decode cache (nested dicts / tuples of tensors)."""
    if isinstance(tree, dict):
        return {k: _clone_cache(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone_cache(v) for v in tree)
    return tree.clone()


class _LogKeep:
    """The engine logger's messages while the block runs."""

    def __enter__(self):
        import logging
        self.messages = []
        keep = self.messages

        class _Keep(logging.Handler):
            def emit(self, r):
                keep.append(r.getMessage())
        self.logger = logging.getLogger("repro_torch.serving")
        self.handler, self.level = _Keep(), self.logger.level
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def phase_lm_families(seed: int, card: str):
    """pixtral_12b (vlm), deepseek_v2_lite_16b (MLA + MoE) and
    qwen3_moe_235b_a22b (MoE; 4 of 94 layers) at full width, bf16, one after
    the other: seeded weights on the card, pruned 80% at 128x128 and served
    through K1 (and K2 / K3 for the attention layers); the vlm forward with
    patch embeddings; the engine dense and paged with exact launch counts;
    decode_step logits kernels vs the plain composition (MoE routing flips
    only at near-ties); the MoE chunked-prefill gate; a profiled decode
    window beside the expert-bytes floor; peak memory."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.tree import flatten_with_path, leaves, path_name
    from repro_torch.kernels import plan_dds
    from repro_torch.kernels.flash_decode import (decode_kernel_override,
                                                  flash_decode,
                                                  paged_flash_decode)
    from repro_torch.models import api as model_api
    from repro_torch.models.api import init_model
    from repro_torch.serving import SchedSpec, ServingSpec, prepare_servable
    dev = torch.device("cuda")
    spec = ServingSpec(tile=(128, 128), sparsity=0.8, prune="tied",
                       fuse_qkv=True, backend="plan_pallas",
                       decode_kernel="flash")
    counts = {"plan_dds": 0, "flash_decode": 0, "paged_flash_decode": 0}
    by_model = {}

    def zero():
        plan_dds.launches = 0
        flash_decode.launches = 0
        paged_flash_decode.launches = 0

    def read():
        return {"plan_dds": plan_dds.launches,
                "flash_decode": flash_decode.launches,
                "paged_flash_decode": paged_flash_decode.launches}

    for name, depth, why in LM_FAMILIES:
        t_model = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = _family_config(name, depth)
        kinds = list(cfg.layer_plan()[0]) + list(cfg.layer_plan()[1]) * \
            cfg.layer_plan()[2] + list(cfg.layer_plan()[3])
        n_attn = sum(1 for k in kinds if k.mixer == "attn")
        n_moe = sum(1 for k in kinds if k.ffn == "moe")
        print(f"[lm_families] {name} ({cfg.family}): {len(kinds)} layers "
              f"({why}); {n_attn} GQA attention ({cfg.n_heads} query / "
              f"{cfg.n_kv_heads} KV heads of {cfg.head_dim}), "
              f"{len(kinds) - n_attn} MLA, {n_moe} MoE FFN ({cfg.n_experts} "
              f"experts top-{cfg.top_k}, {cfg.n_shared_experts} shared); "
              f"d={cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}; card "
              f"{card}")
        t0 = time.perf_counter()
        params = init_model(seed, cfg, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(x.numel() for x in leaves(params))
        servable = prepare_servable(params, cfg, spec, device=dev)
        del params
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        plain = _plain_packs(servable.packs)
        expert_bytes = sum(
            x.numel() * x.element_size()
            for path, x in ((path_name(p), x) for p, x in
                            flatten_with_path(servable.params))
            if "/ffn/" in path and path.rsplit("/", 1)[-1] in ("wi", "wg",
                                                                "wo"))
        k1 = sum(cfg.layer_plan()[2] if k.startswith("blocks/") else 1
                 for k in servable.packs)
        print(f"[lm_families] {name}: {n_params / 1e9:.3f} B parameters, "
              f"init {t_init:.1f} s, prune + export "
              f"{time.perf_counter() - t0 - t_init:.1f} s; "
              f"{len(servable.packs)} packed projection groups "
              f"({sorted({k.split('/', 2)[2] for k in servable.packs})}), "
              f"{k1} K1 launches a decode step and a prefill; routed-expert "
              f"weights {expert_bytes / 1e9:.3f} GB; device memory "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        rng = np.random.RandomState(seed + 7)
        rec = {"layers": len(kinds), "params": n_params, "k1_per_pass": k1}

        if cfg.family == "vlm":
            toks = torch.from_numpy(rng.randint(
                0, cfg.vocab_size, (1, VLM_TOKENS)).astype(np.int32)).to(dev)
            mm = torch.from_numpy((0.02 * rng.randn(
                1, cfg.n_patches, cfg.d_model)).astype(np.float32)).to(
                    dev, cfg.tdtype)
            batch = {"tokens": toks, "mm_embeds": mm}
            with torch.inference_mode():
                zero()
                y_k, _ = model_api.model_forward(servable.params, cfg, batch,
                                                 packs=servable.packs)
                torch.cuda.synchronize()
                got = read()
                y_p, _ = model_api.model_forward(servable.params, cfg, batch,
                                                 packs=plain)
                y_t, _ = model_api.model_forward(
                    servable.params, cfg, {"tokens": toks},
                    packs=servable.packs)
            torch.cuda.synchronize()
            for key, v in got.items():
                counts[key] += v
            check(got == {"plan_dds": k1, "flash_decode": 0,
                          "paged_flash_decode": 0},
                  f"{name}: forward launches {got}, want {k1} K1")
            err = float((y_k - y_p).abs().max())
            scale = float(y_p.abs().max())
            moved = float((y_k[0, 0] - y_t[0, 0]).abs().max())
            print(f"[lm_families] {name}: model_forward (1, {VLM_TOKENS}) "
                  f"with {cfg.n_patches} patch embeddings: {got['plan_dds']}"
                  f" K1 launches, logits kernels vs plain max|d|={err:.4e}, "
                  f"max|logits|={scale:.4e}, tol "
                  f"{TOL_FLASH_VS_XLA * scale:.4e}; the patches move "
                  f"position 0 by {moved:.4e}")
            check(bool(torch.isfinite(y_k).all()), f"{name}: non-finite")
            check(err <= TOL_FLASH_VS_XLA * scale,
                  f"{name}: forward logits with K1 disagree with plain")
            check(moved > 0, f"{name}: mm_embeds did not reach the logits")
            rec["forward"] = {"max_abs_err": err, "max_logits": scale}
            del y_k, y_p, y_t

        prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
                   for n in LM_PROMPTS]
        for layout in ("dense", "paged"):
            eng = servable.engine(max_slots=4, cache_len=1280, sync_every=8,
                                  kv_layout=layout)
            check(eng.kv_layout == layout, f"{name}: fell back from {layout}")
            eng.submit(prompts[0][:8], max_new_tokens=2)
            eng.run()
            eng.stats = type(eng.stats)()
            torch.cuda.synchronize()
            zero()
            t0 = time.perf_counter()
            handles = [eng.submit(p, max_new_tokens=LM_NEW_TOKENS)
                       for p in prompts]
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read()
            for key, v in got.items():
                counts[key] += v
            es = eng.stats
            for h in handles:
                check(h.status == "done" and len(h.tokens) == LM_NEW_TOKENS,
                      f"{name} {layout}: request {h.req_id} {h.status} "
                      f"({h.failure}), {len(h.tokens)} tokens")
            steps = es.steps
            want = {"plan_dds": k1 * (steps + es.prefills),
                    "flash_decode": steps * n_attn if layout == "dense"
                    else 0,
                    "paged_flash_decode": steps * n_attn if layout == "paged"
                    else 0}
            print(f"[lm_families] {name} {layout}: {len(handles)} requests "
                  f"done, {es.tokens_generated} tokens, {steps} decode steps "
                  f"in {es.windows} windows, {es.prefills} prefills (buckets "
                  f"{dict(es.bucket_hits)}); launches {got} (expected {want})")
            check(got == want, f"{name} {layout}: launch counts {got} differ "
                  f"from the layer routing {want}")
            ms = 1e3 * es.decode_s / steps
            print(f"[lm_families] {name} {layout}: wall {wall:.3f} s; "
                  f"prefill {es.prefill_s:.3f} s, decode {es.decode_s:.3f} s"
                  f"; {ms:.3f} ms per decode step, "
                  f"{(es.tokens_generated - es.prefills) / es.decode_s:.1f} "
                  f"decode tokens/s (host clock); kv {eng.kv_stats()}")
            rec[layout] = {"steps": steps, "ms_per_step": ms, "wall_s": wall,
                           "launches": got}
            del eng, handles

        # one fused window over four live slots, under the profiler
        prof_eng = servable.engine(max_slots=4, cache_len=1280, sync_every=8,
                                   kv_layout="dense")
        for p in prompts[:4]:
            prof_eng.submit(p, max_new_tokens=LM_NEW_TOKENS)
        prof_eng._schedule()
        check(sum(1 for s in range(4) if prof_eng._pos[s] >= 0) == 4,
              f"{name}: profiler setup lacks 4 live slots")

        def window(e=prof_eng):
            e.servable.decode_many(
                e.cache, e._dev(e._tokens), e._dev(e._pos), 8,
                remaining=e._dev(e._remaining), eos_id=e._dev(e._eos))
        window()
        label = f"{name} decode window (8 steps, 4 slots)"
        rows = _profile(label, window, top=12)
        _kernel_share(label, rows)
        busy = sum(r[0] for r in rows)
        floor = expert_bytes / HBM_BYTES_PER_S * 1e3
        print(f"[lm_families] {name}: device busy {busy / 8:.3f} ms a decode"
              f" step" + (f"; routed-expert bytes floor {floor:.3f} ms a step"
                          f" ({expert_bytes / 1e9:.3f} GB at 3.35 TB/s: "
                          f"capacity 1 fills every expert's slot, so each "
                          f"step reads them all)" if n_moe else ""))
        rec["window"] = {"busy_ms": busy, "busy_ms_per_step": busy / 8,
                         "expert_floor_ms": floor}
        del prof_eng, window

        # decode_step with the kernels against the plain composition on the
        # same cache (four prefilled slots at ragged positions; each pass
        # rewrites the same rows before it attends)
        cache, tok, pos, _ = _prefill_slots(servable, prompts[:4])

        def step(packs, kernel, log):
            with torch.no_grad(), log, decode_kernel_override(kernel):
                zero()
                y, _ = model_api.decode_step(servable.params, cache, cfg,
                                             tok, pos, packs=packs)
                torch.cuda.synchronize()
            check(bool(torch.isfinite(y).all()),
                  f"{name}: non-finite decode logits")
            return y, read()
        rk, rp = _RouterLog(), _RouterLog()
        y_k, got = step(servable.packs, "flash", rk)
        check(got == {"plan_dds": k1, "flash_decode": n_attn,
                      "paged_flash_decode": 0},
              f"{name}: decode_step launches {got}")
        y_p, got = step(plain, "xla", rp)
        check(got == {"plan_dds": 0, "flash_decode": 0,
                      "paged_flash_decode": 0},
              f"{name}: the plain decode_step launched a kernel {got}")
        err = float((y_k - y_p).abs().max())
        scale = float(y_p.abs().max())
        same = int((y_k.argmax(-1) == y_p.argmax(-1)).sum())
        print(f"[lm_families] {name}: decode_step logits, kernels (K1"
              f"{', K2' if n_attn else ''}) vs plain on the same cache: "
              f"max|d|={err:.4e}, max|logits|={scale:.4e}, tol "
              f"{TOL_FLASH_VS_XLA * scale:.4e}; greedy tokens equal in "
              f"{same} of 4 slots")
        rec["decode_step"] = {"max_abs_err": err, "max_logits": scale}
        flips = 0
        if n_moe:
            flips = len(_routing_flips(f"[lm_families] {name}", rk, rp,
                                       cfg.top_k))
            # a routing flip at a near-tie moves whole expert outputs (and,
            # at capacity 1, which tokens are dropped): hold the kernels'
            # arithmetic with the plain pass routed as the kernel pass was
            y_r, _ = step(plain, "xla", _RouterLog(replay=rk))
            err_r = float((y_k - y_r).abs().max())
            scale_r = float(y_r.abs().max())
            print(f"[lm_families] {name}: decode_step logits with the plain "
                  f"pass routed as the kernel pass: max|d|={err_r:.4e}, "
                  f"max|logits|={scale_r:.4e}, tol "
                  f"{TOL_FLASH_VS_XLA * scale_r:.4e}")
            check(err_r <= TOL_FLASH_VS_XLA * scale_r,
                  f"{name}: decode_step logits with the kernels disagree "
                  f"under the same routing")
            rec["decode_step"].update(routing_flips=flips,
                                      max_abs_err_same_routing=err_r,
                                      max_logits_same_routing=scale_r)
            del y_r
        # without a routing flip the two passes must agree as they are
        check(flips > 0 or err <= TOL_FLASH_VS_XLA * scale,
              f"{name}: decode_step logits with the kernels disagree")
        del cache, y_k, y_p, rk, rp

        if n_moe:
            # chunked prefill: the engine logs its blocker, admits one-shot
            with _LogKeep() as logs:
                eng = servable.engine(max_slots=4, cache_len=1280,
                                      sync_every=8,
                                      sched=SchedSpec(max_chunk=256))
            hs = [eng.submit(p[:n], max_new_tokens=4)
                  for p, n in zip(prompts, GATE_PROMPTS)]
            eng.run()
            blocker = [m for m in logs.messages if "MoE ffn" in m]
            print(f"[lm_families] {name}: SchedSpec(max_chunk=256): "
                  f"chunking {eng._chunking}, {eng.stats.prefill_chunks} "
                  f"chunks, {eng.stats.prefills} one-shot prefills, "
                  f"statuses {[h.status for h in hs]}; logged: {blocker}")
            check(not eng._chunking and eng.stats.prefill_chunks == 0
                  and all(h.status == "done" for h in hs) and blocker,
                  f"{name}: the MoE chunked-prefill gate did not fall back")
            del eng, hs

        del servable, plain
        gc.collect()
        torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated()
        rec["peak_gib"] = peak / 2**30
        rec["seconds"] = time.perf_counter() - t_model
        print(f"[lm_families] {name}: peak device memory {peak / 2**30:.2f} "
              f"GiB (torch.cuda.max_memory_allocated), {rec['seconds']:.1f} "
              f"s; freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"still allocated")
        by_model[name] = rec
    print(f"[lm_families] summary {json.dumps(by_model)}")
    return counts


# --------------------------------------------------------------------------
# phase 4d: lm_recurrent -- the ssm, hybrid and audio families
# --------------------------------------------------------------------------

RECURRENT_MODELS = ("mamba2_780m", "recurrentgemma_9b", "whisper_base")
# a prompt prefilled both ways: one pass, and token by token through decode
PREFILL_PATHS_TOKENS = 300
# one-pass prefill logits at the last prompt position against token-by-token
# decode prefill of the same prompt, and the next decode step from each
# cache: the SSD / RG-LRU chunked algorithms against their recurrences in
# bf16 (the one-pass path's matmuls take M = bucket rows, the decode path's
# M = 1, so every layer's bf16 activations round apart and 38-48 residual
# layers carry it to the logits). Bar: 5% of max|logits|, as the kernels
# against the plain composition.
TOL_PREFILL_PATHS = 5e-2
# mamba2_780m's bf16 gap on random weights is ~4.5% (its logits are small:
# max ~3), so the same check also runs on an fp32 copy of the model, where
# the two paths differ only by fp32 sums in another order: 64 tokens, bar
# 1e-3 of max|logits| (fp32 matmuls at another M, 48 layers)
PREFILL_PATHS_FP32 = {"mamba2_780m": 64}
TOL_PREFILL_PATHS_FP32 = 1e-3
# whisper_base: 4 requests, each with 1500 seeded frame embeddings (the conv
# frontend is a stub in both packages), the 4-token start-of-transcript
# prompt (<|startoftranscript|><|en|><|transcribe|><|notimestamps|>), 64 new
# tokens, Whisper's 448-token text context as cache_len
AUDIO_PROMPT = (50258, 50259, 50359, 50363)
AUDIO_REQUESTS = 4
AUDIO_NEW_TOKENS = 64
AUDIO_CACHE_LEN = 448


#: the recurrent models' depth in lm_recurrent, the single-device serving
#: phase: mamba2_780m and recurrentgemma_9b cut to about half their layers
#: (48 -> 24; 38 -> 20, 6 periods of its RG-LRU, RG-LRU, local pattern and
#: its 2 RG-LRU suffix layers) to fit lm_tp_train in the run's time limit;
#: whisper_base whole. The mesh phases run them at full depth.
RECURRENT_LAYERS = {"mamba2_780m": 24, "recurrentgemma_9b": 20}


def _recurrent_depth(name, cfg):
    """How much of the published depth ``cfg`` has (printed)."""
    full = {"mamba2_780m": 48, "recurrentgemma_9b": 38}.get(name)
    if full is None or cfg.n_layers == full:
        return "full width and depth"
    return f"full width, {cfg.n_layers} of {full} layers"


def _recurrent_config(name, cut=False):
    """The published widths, checked; with ``cut``, the depth cut to
    ``RECURRENT_LAYERS``."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    got, want = {
        "mamba2_780m": ((cfg.n_layers, cfg.d_model, cfg.ssm_state,
                         cfg.ssm_expand, cfg.ssm_head_dim, cfg.vocab_size),
                        (48, 1536, 128, 2, 64, 50280)),
        "recurrentgemma_9b": ((cfg.n_layers, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                               cfg.rnn_width, cfg.vocab_size),
                              (38, 4096, 16, 1, 256, 12288, 4096, 256000)),
        "whisper_base": ((cfg.n_enc_layers, cfg.n_layers, cfg.d_model,
                          cfg.n_heads, cfg.head_dim, cfg.vocab_size,
                          cfg.n_audio_ctx),
                         (6, 6, 512, 8, 64, 51865, 1500))}[name]
    check(got == want, f"{name} is not the published configuration: {got}")
    if cut and name in RECURRENT_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=RECURRENT_LAYERS[name])
    return cfg


def _prefill_paths(name, servable, p, tol):
    """One-pass prefill of prompt ``p`` against token-by-token decode
    prefill: the last position's logits and the next decode step from each
    cache, within ``tol`` of max|logits|."""
    import numpy as np
    import torch
    bucket = 1 << (len(p) - 1).bit_length()
    padded = np.zeros((bucket,), np.int32)
    padded[:len(p)] = p
    sub = servable.init_cache(1, 1280)
    sub, logits = servable.engine_prefill(
        sub, torch.from_numpy(padded).to(servable.device), len(p))
    row_one = logits[len(p) - 1].float()
    seq = servable.init_cache(1, 1280)
    t0 = time.perf_counter()
    for t, tk in enumerate(p):
        y, seq = servable.decode_step(seq, [[tk]], t)
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    row_seq = y[0, 0].float()
    nxt = int(row_seq.argmax())
    ya, _ = servable.decode_step(sub, [[nxt]], len(p))
    yb, _ = servable.decode_step(seq, [[nxt]], len(p))
    torch.cuda.synchronize()
    err = float((row_one - row_seq).abs().max())
    scale = float(row_seq.abs().max())
    err2 = float((ya - yb).abs().max())
    scale2 = float(yb.abs().max())
    top2 = torch.topk(row_seq, 2).values
    print(f"[lm_recurrent] {name} ({servable.cfg.dtype}): {len(p)}-token "
          f"prompt, one-pass prefill (bucket {bucket}) vs token by token "
          f"({t_seq:.2f} s): last-position logits max|d|={err:.4e}, "
          f"max|logits|={scale:.4e}, tol {tol * scale:.4e}, argmax "
          f"{'equal' if int(row_one.argmax()) == nxt else 'differs'} "
          f"(top-2 margin {float(top2[0] - top2[1]):.4e}); the next decode "
          f"step from both caches max|d|={err2:.4e} of {scale2:.4e}")
    check(bool(torch.isfinite(row_one).all()) and err <= tol * scale and
          err2 <= tol * scale2, f"{name} ({servable.cfg.dtype}): the one-"
          f"pass prefill disagrees with token-by-token prefill")
    return {"tokens": len(p), "max_abs_err": err, "max_logits": scale,
            "next_step_max_abs_err": err2, "next_step_max_logits": scale2}


def _recurrent_lm(name, cfg, servable, rng, zero, read, counts, rec):
    """mamba2_780m / recurrentgemma_9b through the engine: paged asked and
    refused, chunked prefill beside one-shot, one-pass against token-by-
    token prefill, decode_step logits kernels vs plain."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode import decode_kernel_override
    from repro_torch.models import api as model_api
    from repro_torch.serving import SchedSpec
    prefix, pattern, n_per, suffix = cfg.layer_plan()
    kinds = list(prefix) + list(pattern) * n_per + list(suffix)
    n_attn = sum(1 for k in kinds if k.mixer in ("attn", "local"))
    k1 = rec["k1_per_pass"]
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in LM_PROMPTS]
    n_oneshot = sum(1 for p in prompts if len(p) <= SCHED_CHUNK)
    runs = {}
    for kind in ("one-shot", "chunked"):
        with _LogKeep() as logs:
            eng = servable.engine(
                max_slots=4, cache_len=1280, sync_every=8, kv_layout="paged",
                sched=SchedSpec(max_chunk=SCHED_CHUNK)
                if kind == "chunked" else None)
        blocker = [m for m in logs.messages
                   if "no linear attention/MLA layers to page" in m]
        check(eng.kv_layout == "dense" and blocker and eng._chunking ==
              (kind == "chunked"), f"{name} {kind}: kv_layout "
              f"{eng.kv_layout}, chunking {eng._chunking}, logged "
              f"{logs.messages}")
        eng.submit(prompts[0][:8], max_new_tokens=2)          # warm-up
        eng.run()
        eng.stats = type(eng.stats)()
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        hs = [eng.submit(p, max_new_tokens=LM_NEW_TOKENS) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read()
        for key, v in got.items():
            counts[key] += v
        es = eng.stats
        for h in hs:
            check(h.status == "done" and len(h.tokens) == LM_NEW_TOKENS,
                  f"{name} {kind}: request {h.req_id} {h.status} "
                  f"({h.failure}), {len(h.tokens)} tokens")
        passes = es.steps + (es.prefills if kind == "one-shot"
                             else n_oneshot + es.prefill_chunks)
        want = {"plan_dds": k1 * passes, "flash_decode": n_attn * es.steps,
                "paged_flash_decode": 0}
        print(f"[lm_recurrent] {name} {kind} (paged asked, logged "
              f"{blocker[0]!r}): {len(hs)} requests done, "
              f"{es.tokens_generated} tokens, {es.steps} decode steps in "
              f"{es.windows} windows, {es.prefills} prefills, "
              f"{es.prefill_chunks} chunks; launches {got} (expected {want})")
        check(got == want, f"{name} {kind}: launch counts {got} differ from "
              f"the layer routing {want}")
        if kind == "chunked":
            check(es.prefill_chunks > len(prompts) - n_oneshot,
                  f"{name}: {es.prefill_chunks} chunks is no multi-chunk "
                  f"prefill")
        ms = 1e3 * es.decode_s / es.steps
        print(f"[lm_recurrent] {name} {kind}: wall {wall:.3f} s; prefill "
              f"{es.prefill_s:.3f} s, decode {es.decode_s:.3f} s; {ms:.3f} "
              f"ms per decode step, "
              f"{(es.tokens_generated - es.prefills) / es.decode_s:.1f} "
              f"decode tokens/s (host clock); kv {eng.kv_stats()}")
        rec[kind] = {"steps": es.steps, "ms_per_step": ms, "wall_s": wall,
                     "launches": got}
        runs[kind] = [list(h.tokens) for h in hs]
        del eng, hs
    agree = sum(a == b for ra, rb in zip(runs["one-shot"], runs["chunked"])
                for a, b in zip(ra, rb))
    print(f"[lm_recurrent] {name}: greedy tokens chunked vs one-shot {agree} "
          f"of {len(prompts) * LM_NEW_TOKENS} equal")
    rec["chunked_tokens_equal"] = agree
    # first tokens: one-shot against chunk-by-chunk prefill of the same
    # prompts (a differing argmax only at a near-tie), then a decode step
    # from both caches
    cache1, tok, pos, rows1 = _prefill_slots(servable, prompts[:4])
    cache2, rows2, _ = _chunk_prefill_slots(servable, prompts[:4], k1)
    _margin_check(name, rows1, rows2)
    y1, _ = servable.decode_step(cache1, tok, pos)
    y2, _ = servable.decode_step(cache2, tok, pos)
    torch.cuda.synchronize()
    err, scale = float((y1 - y2).abs().max()), float(y1.abs().max())
    print(f"[lm_recurrent] {name}: decode_step logits after chunked vs "
          f"one-shot prefill: max|d|={err:.4e}, max|logits|={scale:.4e}, "
          f"tol {TOL_KV_DECODE * scale:.4e}")
    check(bool(torch.isfinite(y2).all()) and err <= TOL_KV_DECODE * scale,
          f"{name}: decode_step logits after a chunked prefill disagree "
          f"with the one-shot caches'")
    rec["chunked_decode_step"] = {"max_abs_err": err, "max_logits": scale}
    del cache2, y1, y2

    rec["prefill_paths"] = _prefill_paths(
        name, servable, prompts[1][:PREFILL_PATHS_TOKENS], TOL_PREFILL_PATHS)

    # decode_step with the kernels against the plain composition, each
    # from its own copy of the same cache (a step advances the recurrent
    # state in place)
    if k1 or n_attn:
        plain = _plain_packs(servable.packs)

        def step(packs, kernel):
            c = _clone_cache(cache1)
            with torch.no_grad(), decode_kernel_override(kernel):
                zero()
                y, _ = model_api.decode_step(servable.params, c, cfg,
                                             tok, pos, packs=packs)
                torch.cuda.synchronize()
            check(bool(torch.isfinite(y).all()),
                  f"{name}: non-finite decode logits")
            return y, read()
        y_k, got = step(servable.packs, "flash")
        check(got == {"plan_dds": k1, "flash_decode": n_attn,
                      "paged_flash_decode": 0},
              f"{name}: decode_step launches {got}")
        y_p, got = step(plain, "xla")
        check(got == {"plan_dds": 0, "flash_decode": 0,
                      "paged_flash_decode": 0},
              f"{name}: the plain decode_step launched a kernel {got}")
        err, scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
        same = int((y_k.argmax(-1) == y_p.argmax(-1)).sum())
        print(f"[lm_recurrent] {name}: decode_step logits, kernels (K1, K2) "
              f"vs plain on the same cache: max|d|={err:.4e}, max|logits|="
              f"{scale:.4e}, tol {TOL_FLASH_VS_XLA * scale:.4e}; greedy "
              f"tokens equal in {same} of 4 slots")
        check(err <= TOL_FLASH_VS_XLA * scale,
              f"{name}: decode_step logits with the kernels disagree")
        rec["decode_step"] = {"max_abs_err": err, "max_logits": scale}
        del plain, y_k, y_p
    else:
        print(f"[lm_recurrent] {name}: no K1 / K2 on this path (no packs, no "
              f"attention): decode runs the plain composition")
    del cache1

    # one fused window over four live slots, under the profiler
    prof_eng = servable.engine(max_slots=4, cache_len=1280, sync_every=8)
    for p in prompts[:4]:
        prof_eng.submit(p, max_new_tokens=LM_NEW_TOKENS)
    prof_eng._schedule()
    check(sum(1 for s in range(4) if prof_eng._pos[s] >= 0) == 4,
          f"{name}: profiler setup lacks 4 live slots")
    return prof_eng


def _recurrent_audio(name, cfg, servable, rng, zero, read, counts, rec):
    """whisper_base through the engine (frames per request, prompts
    prefilled through the decode path), its paged / chunked blockers,
    decode_step logits K2 vs plain, teacher-forced forward vs per-step
    decode."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode import decode_kernel_override
    from repro_torch.models import api as model_api
    from repro_torch.serving import SchedSpec
    n_dec = cfg.n_layers
    frames = [(rng.randn(cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
              for _ in range(AUDIO_REQUESTS)]
    prompt = list(AUDIO_PROMPT)
    eng = servable.engine(max_slots=4, cache_len=AUDIO_CACHE_LEN,
                          sync_every=8)
    eng.submit(prompt, max_new_tokens=2, frames=frames[0])       # warm-up
    eng.run()
    eng.stats = type(eng.stats)()
    torch.cuda.synchronize()
    zero()
    t0 = time.perf_counter()
    hs = [eng.submit(prompt, max_new_tokens=AUDIO_NEW_TOKENS, frames=f)
          for f in frames]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read()
    for key, v in got.items():
        counts[key] += v
    es = eng.stats
    for h in hs:
        check(h.status == "done" and len(h.tokens) == AUDIO_NEW_TOKENS,
              f"{name}: request {h.req_id} {h.status} ({h.failure}), "
              f"{len(h.tokens)} tokens")
    prefill_steps = sum(b * n for b, n in es.bucket_hits.items())
    want = {"plan_dds": 0, "flash_decode": n_dec * (es.steps + prefill_steps),
            "paged_flash_decode": 0}
    print(f"[lm_recurrent] {name}: {len(hs)} requests of {cfg.n_audio_ctx} "
          f"frames done, {es.tokens_generated} tokens, {es.steps} decode "
          f"steps in {es.windows} windows, {es.prefills} prefills through "
          f"the decode path ({prefill_steps} steps, buckets "
          f"{dict(es.bucket_hits)}); launches {got} (expected {want}: "
          f"{n_dec} K2 a step, padding steps included; cross-attention is "
          f"the plain composition)")
    check(got == want, f"{name}: launch counts {got} differ from the "
          f"layer routing {want}")
    ms = 1e3 * es.decode_s / es.steps
    print(f"[lm_recurrent] {name}: wall {wall:.3f} s; prefill "
          f"{es.prefill_s:.3f} s (encoder + prompt), decode "
          f"{es.decode_s:.3f} s; {ms:.3f} ms per decode step (host clock)")
    rec["dense"] = {"steps": es.steps, "ms_per_step": ms, "wall_s": wall,
                    "prefill_s": es.prefill_s, "launches": got}
    tokens0 = list(hs[0].tokens)
    del eng, hs

    # paged and chunked asked: both blockers logged, dense one-shot served
    with _LogKeep() as logs:
        eng = servable.engine(max_slots=4, cache_len=AUDIO_CACHE_LEN,
                              sync_every=8, kv_layout="paged",
                              sched=SchedSpec(max_chunk=SCHED_CHUNK))
    hs = [eng.submit(prompt, max_new_tokens=4, frames=f) for f in frames[:2]]
    eng.run()
    want_logs = ("family 'audio' (cross-attn caches are per-request)",
                 "family 'audio' prefills through the decode path")
    seen = [w for w in want_logs if any(w in m for m in logs.messages)]
    print(f"[lm_recurrent] {name}: paged + SchedSpec(max_chunk="
          f"{SCHED_CHUNK}) asked: kv_layout {eng.kv_layout}, chunking "
          f"{eng._chunking}, {eng.stats.prefill_chunks} chunks, statuses "
          f"{[h.status for h in hs]}; logged {seen}")
    check(eng.kv_layout == "dense" and not eng._chunking and
          eng.stats.prefill_chunks == 0 and len(seen) == 2 and
          all(h.status == "done" for h in hs),
          f"{name}: the audio paged / chunked blockers did not fall back")
    del eng, hs

    # decode_step logits, K2 vs the plain composition, on one cache of four
    # slots at ragged positions
    dev = servable.device
    lens = [4, 20, 37, 9]
    cache = servable.init_cache(4, AUDIO_CACHE_LEN, frames=np.stack(frames))
    toks = rng.randint(0, cfg.vocab_size, (4, max(lens))).astype(np.int32)
    for t in range(max(lens)):
        p = torch.tensor([t if t < n else -1 for n in lens],
                         dtype=torch.int32, device=dev)
        servable.decode_step(cache, toks[:, t:t + 1], p)
    tok = torch.from_numpy(toks[:, :1]).to(dev)
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)

    def step(kernel):
        c = _clone_cache(cache)
        with torch.no_grad(), decode_kernel_override(kernel):
            zero()
            y, _ = model_api.decode_step(servable.params, c, cfg, tok, pos)
            torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()), f"{name}: non-finite logits")
        return y, read()
    y_k, got = step("flash")
    check(got == {"plan_dds": 0, "flash_decode": n_dec,
                  "paged_flash_decode": 0},
          f"{name}: decode_step launches {got}")
    y_p, got = step("xla")
    check(got == {"plan_dds": 0, "flash_decode": 0, "paged_flash_decode": 0},
          f"{name}: the plain decode_step launched a kernel {got}")
    err, scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
    print(f"[lm_recurrent] {name}: decode_step logits at positions {lens}, "
          f"K2 vs plain on the same cache: max|d|={err:.4e}, max|logits|="
          f"{scale:.4e}, tol {TOL_FLASH_VS_XLA * scale:.4e}")
    check(err <= TOL_FLASH_VS_XLA * scale,
          f"{name}: decode_step logits with K2 disagree")
    rec["decode_step"] = {"max_abs_err": err, "max_logits": scale}
    del cache, y_k, y_p

    # teacher-forced forward against per-step decode logits: request 0's
    # prompt and generated tokens
    seq_toks = prompt + tokens0[:-1]
    fwd = servable.forward({"tokens": np.asarray([seq_toks], np.int32),
                            "frames": frames[0][None]})[0]
    cache1 = servable.init_cache(1, AUDIO_CACHE_LEN, frames=frames[0][None])
    rows = []
    for t, tk in enumerate(seq_toks):
        y, cache1 = servable.decode_step(cache1, [[tk]], t)
        rows.append(y[0, 0])
    dec = torch.stack(rows)
    torch.cuda.synchronize()
    err, scale = float((fwd - dec).abs().max()), float(dec.abs().max())
    same = int((fwd.argmax(-1) == dec.argmax(-1)).sum())
    gen_same = sum(int(a) == b for a, b in zip(
        fwd[len(prompt) - 1:].argmax(-1).tolist(), tokens0))
    print(f"[lm_recurrent] {name}: teacher-forced forward vs per-step decode "
          f"over {len(seq_toks)} positions: max|d|={err:.4e}, max|logits|="
          f"{scale:.4e}, tol {TOL_PREFILL_PATHS * scale:.4e}; argmax equal "
          f"at {same} positions, the forward's greedy tokens equal the "
          f"engine's at {gen_same} of {len(tokens0)}")
    check(bool(torch.isfinite(fwd).all()) and
          err <= TOL_PREFILL_PATHS * scale,
          f"{name}: the teacher-forced forward disagrees with decode")
    rec["forward_vs_decode"] = {"max_abs_err": err, "max_logits": scale}
    del cache1, fwd, dec

    prof_eng = servable.engine(max_slots=4, cache_len=AUDIO_CACHE_LEN,
                               sync_every=8)
    for f in frames:
        prof_eng.submit(prompt, max_new_tokens=AUDIO_NEW_TOKENS, frames=f)
    prof_eng._schedule()
    check(sum(1 for s in range(4) if prof_eng._pos[s] >= 0) == 4,
          f"{name}: profiler setup lacks 4 live slots")
    return prof_eng


def phase_lm_recurrent(seed: int, card: str):
    """mamba2_780m (ssm), recurrentgemma_9b (hybrid: RG-LRU + MQA local
    attention) and whisper_base (audio enc-dec) at full width and depth,
    bf16, one after the other, each freed before the next: seeded weights on
    the card, the lm_families spec (pruned 80% at 128x128, tied masks, K1
    for every pack, K2 for decode attention). mamba2 has no packs and no
    attention (no kernel on its path); recurrentgemma packs its FFNs and
    local-attention projections (its RG-LRU projections stay dense, as in
    the reference); whisper exports nothing and serves dense (K2 on its
    decoder self-attention). Each: the engine with every request done and
    launches equal to the routing; the paged (and for whisper chunked)
    blockers logged; decode_step logits kernels vs plain; for the recurrent
    two chunked prefill beside one-shot and one-pass against token-by-token
    prefill; for whisper the teacher-forced forward against per-step
    decode; a profiled decode window; peak memory. mamba2's one-pass vs
    token-by-token check also runs on an fp32 copy of the model."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.core.tree import leaves
    from repro_torch.kernels import plan_dds
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)
    from repro_torch.models.api import init_model
    from repro_torch.serving import ServingSpec, prepare_servable
    dev = torch.device("cuda")
    spec = ServingSpec(tile=(128, 128), sparsity=0.8, prune="tied",
                       fuse_qkv=True, backend="plan_pallas",
                       decode_kernel="flash")
    counts = {"plan_dds": 0, "flash_decode": 0, "paged_flash_decode": 0}
    by_model = {}

    def zero():
        plan_dds.launches = 0
        flash_decode.launches = 0
        paged_flash_decode.launches = 0

    def read():
        return {"plan_dds": plan_dds.launches,
                "flash_decode": flash_decode.launches,
                "paged_flash_decode": paged_flash_decode.launches}

    for name in RECURRENT_MODELS:
        t_model = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = _recurrent_config(name, cut=True)
        prefix, pattern, n_per, suffix = cfg.layer_plan()
        kinds = list(prefix) + list(pattern) * n_per + list(suffix)
        mixers = {m: sum(1 for k in kinds if k.mixer == m)
                  for m in sorted({k.mixer for k in kinds})}
        enc = (f"{cfg.n_enc_layers} encoder + "
               if cfg.family == "audio" else "")
        print(f"[lm_recurrent] {name} ({cfg.family}): {enc}{len(kinds)} "
              f"layers {mixers}, {_recurrent_depth(name, cfg)}; "
              f"d={cfg.d_model}, "
              f"vocab {cfg.vocab_size}, {cfg.dtype}; card {card}")
        t0 = time.perf_counter()
        params = init_model(seed, cfg, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(x.numel() for x in leaves(params))
        servable = prepare_servable(params, cfg, spec, device=dev)
        del params
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        k1 = sum(n_per if k.startswith("blocks/") else 1
                 for k in servable.packs)
        weight_bytes = sum(x.numel() * x.element_size()
                           for x in leaves(servable.params))
        print(f"[lm_recurrent] {name}: {n_params / 1e9:.3f} B parameters, "
              f"init {t_init:.1f} s, prune + export "
              f"{time.perf_counter() - t0 - t_init:.1f} s; "
              f"{len(servable.packs)} packed projection groups "
              f"({sorted({k.split('/', 2)[2] for k in servable.packs})}), "
              f"{k1} K1 launches a decode step and a prefill; served weights "
              f"{weight_bytes / 1e9:.3f} GB; device memory "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        rng = np.random.RandomState(seed + 11)
        rec = {"layers": len(kinds), "params": n_params, "k1_per_pass": k1,
               "weight_bytes": weight_bytes}
        drive = _recurrent_audio if cfg.family == "audio" else _recurrent_lm
        prof_eng = drive(name, cfg, servable, rng, zero, read, counts, rec)

        def window(e=prof_eng):
            e.servable.decode_many(
                e.cache, e._dev(e._tokens), e._dev(e._pos), 8,
                remaining=e._dev(e._remaining), eos_id=e._dev(e._eos))
        window()
        label = f"{name} decode window (8 steps, 4 slots)"
        rows = _profile(label, window, top=12)
        _kernel_share(label, rows)
        busy = sum(r[0] for r in rows)
        print(f"[lm_recurrent] {name}: device busy {busy / 8:.3f} ms a "
              f"decode step")
        rec["window"] = {"busy_ms": busy, "busy_ms_per_step": busy / 8}
        del prof_eng, window, servable
        gc.collect()
        torch.cuda.empty_cache()
        if name in PREFILL_PATHS_FP32:
            f32 = dataclasses.replace(cfg, dtype="float32")
            params = init_model(seed, f32, device=dev)
            servable = prepare_servable(params, f32, spec, device=dev)
            del params
            p = np.random.RandomState(seed + 12).randint(
                0, cfg.vocab_size, PREFILL_PATHS_FP32[name]).tolist()
            rec["prefill_paths_fp32"] = _prefill_paths(
                name, servable, p, TOL_PREFILL_PATHS_FP32)
            del servable
            gc.collect()
            torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated()
        rec["peak_gib"] = peak / 2**30
        rec["seconds"] = time.perf_counter() - t_model
        print(f"[lm_recurrent] {name}: peak device memory {peak / 2**30:.2f} "
              f"GiB (torch.cuda.max_memory_allocated), {rec['seconds']:.1f} "
              f"s; freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"still allocated")
        by_model[name] = rec
    print(f"[lm_recurrent] summary {json.dumps(by_model)}")
    return counts


# --------------------------------------------------------------------------
# phase 4e: LM training -- the flash-attention backward at gemma3_4b's
# global-layer shape, one gemma3_4b step at full width and depth, remat and
# donation, the Trainer loop, the hand-off to serving (K1, K2) and packed
# fine-tuning (K1, K4, K5); every other LM family's step on the card
# against the CPU
# --------------------------------------------------------------------------

LMT_SEQ = 4096          # train_4k's sequence length; its batch cut to 1
LMT_TIMED_STEPS = 3
LMT_LAYERS = 6          # checks c-f: one 5 local : 1 global period
LMT_SHORT_SEQ = 2048    # ... at S 2048: flash (S > 1024) and local (S > 1024)
LMT_REQUESTS = (37, 300, 700, 1100)
LMT_PACKED_STEPS = 2
# flash dq / dk / dv against autograd through full_attention on the same
# inputs, in units of each gradient's max|g|: fp32 sums in another order
# (1e-4); bf16 probabilities and ds tiles rounded to bf16 in the flash
# backward where autograd's softmax backward keeps fp32 (2e-2)
TOL_FLASH_GRAD = {"float32": 1e-4, "bfloat16": 2e-2}
# the packed fine-tuning step's cross-entropy against the dense forward of
# the unpacked (masked) weights: bf16 through 6 layers, K1 summing tiles in
# another order than a dense matmul (relative)
TOL_PACKED_DENSE = 1e-2
# K1's output, K4's dX and K5's tile gradients inside a packed step at
# M = 2048, against fp32 products of the same bf16 X, dY and tiles, in
# units of the reference's max|.|: each kernel accumulates in fp32 and
# rounds its output to bf16 once, at most bf16's unit roundoff 2^-8 of an
# element (the plain versions on the CPU: 3.1e-3 to 3.6e-3); twice that
TOL_PACKED_KERNEL = 2 * 2.0 ** -8
# each smoke family's train-step loss and grad norm, card vs CPU, fp32
# (relative): fp32 sums in another order through 2-8 layers
TOL_FAMILY_STEP = 1e-4
TRAIN_FAMILIES = ("deepseek_7b", "chatglm3_6b", "internlm2_20b",
                  "qwen3_moe_235b_a22b", "deepseek_v2_lite_16b",
                  "mamba2_780m", "recurrentgemma_9b", "pixtral_12b",
                  "whisper_base")


def _lmt_flash(dev):
    """a. _Flash's dq, dk, dv at gemma3_4b's global-layer shape against
    autograd through full_attention, fp32 and bf16; fwd+bwd ms beside
    SDPA's (the yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.attention import flash_attention, full_attention
    b, s, hq, hkv, d = 1, LMT_SEQ, 8, 4, 256
    gen = torch.Generator(device=dev).manual_seed(40)
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, do = (torch.randn((b, s, hq, d), generator=gen,
                             device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn((b, s, hkv, d), generator=gen,
                            device=dev).to(dtype) for _ in range(2))

        def grads(fn, x=(q, k, v), dy=do):
            x = [t.detach().requires_grad_(True) for t in x]
            return torch.autograd.grad(fn(*x), x, dy)

        def flash(a, b_, c):
            return flash_attention(a, b_, c, causal=True, q_chunk=1024,
                                   kv_chunk=1024)

        def full(a, b_, c):
            return full_attention(a, b_, c, causal=True)
        got, ref = grads(flash), grads(full)
        errs = {}
        for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
            scale = float(r.float().abs().max())
            errs[gname] = float((g.float() - r.float()).abs().max()) / scale
            check(bool(torch.isfinite(g).all())
                  and errs[gname] <= TOL_FLASH_GRAD[name],
                  f"flash {gname} ({name}) differs from autograd through "
                  f"full_attention by {errs[gname]:.3e} of max|g|")
        del got, ref
        # SDPA on (B, H, S, D) with K/V repeated to the query heads
        qs, dos = q.transpose(1, 2), do.transpose(1, 2)
        ks, vs = (x.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                  for x in (k, v))
        times = {
            "flash_ms": _time_ms(lambda: grads(flash), reps=5, warmup=1),
            "full_ms": _time_ms(lambda: grads(full), reps=5, warmup=1),
            "sdpa_ms": _time_ms(lambda: grads(
                lambda a, b_, c: F.scaled_dot_product_attention(
                    a, b_, c, is_causal=True), (qs, ks, vs), dos),
                reps=5, warmup=1)}
        print(f"[lm_training] a. flash backward {name} (B {b}, S {s}, Hq "
              f"{hq}, Hkv {hkv}, D {d}, chunks 1024, causal) vs autograd "
              f"through full_attention: max|d|/max|g| "
              f"{ {k_: f'{e:.3e}' for k_, e in errs.items()} } (tol "
              f"{TOL_FLASH_GRAD[name]}); fwd+bwd ms (CUDA events, 5 "
              f"calls): flash {times['flash_ms']:.3f}, full_attention "
              f"{times['full_ms']:.3f}, SDPA (yardstick only) "
              f"{times['sdpa_ms']:.3f}")
        rec[name] = {"rel_err": errs, **times}
        del q, k, v, do, qs, ks, vs, dos
    return rec


def _lmt_full_depth(seed, dev, card):
    """b. One gemma3_4b step at full width and depth (34 layers, bf16
    params, fp32 AdamW state, the prox on) through make_train_step(donate=
    True) at B 1, S 4096: a warm-up step, LMT_TIMED_STEPS timed steps and
    one profiled step."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import init_model
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    sp = SparsityConfig(block_shape=(16, 16), sparsity=0.7, lambda_reg=1e-4)
    cfg = dataclasses.replace(_lm_config(), sparsity=sp)
    opt = AdamWConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(seed, cfg, device=dev)
    state = init_opt_state(params, opt)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(params))
    pipe = DataPipeline(DataConfig(seq_len=LMT_SEQ, global_batch=1,
                                   vocab_size=cfg.vocab_size))
    batches = [{k: torch.from_numpy(v).to(dev, torch.int64)
                for k, v in pipe.batch_at(i).items()}
               for i in range(LMT_TIMED_STEPS + 2)]
    pipe.close()
    step = make_train_step(cfg, opt, donate=True)
    snap = [p.reshape(-1)[:1 << 16].clone() for p in leaves(params)]
    ptrs = [p.data_ptr() for p in leaves(params)]
    print(f"[lm_training] b. {cfg.arch}: {n_params / 1e9:.3f} B parameters "
          f"({cfg.n_layers} layers, d {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, tied head), bf16 params + fp32 AdamW state, "
          f"prox {sp.block_shape} lambda {sp.lambda_reg}; init {t_init:.1f} "
          f"s; B 1, S {LMT_SEQ}; card {card}")
    losses, ms = [], []
    for i, batch in enumerate(batches[:-1]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, m = step(params, state, batch)
        end.record()
        torch.cuda.synchronize()
        losses.append(float(m["loss"]))
        if i:                                    # step 0 is the warm-up
            ms.append(start.elapsed_time(end))
    check(all(np.isfinite(losses)), f"full-depth loss {losses}")
    check([p.data_ptr() for p in leaves(params)] == ptrs,
          "the donated step did not update the params in place")
    moved = [int((p.reshape(-1)[:1 << 16] != s).sum())
             for p, s in zip(leaves(params), snap)]
    check(all(n > 0 for n in moved), f"{moved.count(0)} parameter leaves "
          f"did not move in {len(losses)} steps")
    rows = _profile(f"{cfg.arch} full-depth train step (B 1, S {LMT_SEQ})",
                    lambda: step(params, state, batches[-1]), top=12)
    busy = sum(r[0] for r in rows)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    step_ms = float(np.median(ms))
    tokens = LMT_SEQ
    share = 6 * n_params * tokens / (step_ms * 1e-3 * BF16_FLOP_PER_S)
    print(f"[lm_training] b. losses by step {[round(x, 4) for x in losses]};"
          f" elements moved in the first 65536 of each leaf: min "
          f"{min(moved)}, median {int(np.median(moved))}, of "
          f"{len(moved)} leaves (bf16 params, lr warm-up 3e-6 a step: only "
          f"elements near 0 change in bf16)")
    print(f"[lm_training] b. ms a step (CUDA events, {len(ms)} steps): "
          f"median {step_ms:.1f}, min {min(ms):.1f}, max {max(ms):.1f}; "
          f"{tokens / (step_ms * 1e-3):.1f} tokens/s; 6 N tokens / (step "
          f"s x 989 TFLOP/s) = {share:.4f} (a reading, not a limit); peak "
          f"device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) of {total / 2**30:.2f} GiB")
    check(peak < total, "peak memory above the card's")
    rec = {"n_params": n_params, "seq": LMT_SEQ, "losses": losses,
           "ms": ms, "ms_median": step_ms, "tokens_per_s":
           tokens / (step_ms * 1e-3), "flop_share": share,
           "peak_gib": peak / 2**30, "busy_ms": busy}
    del params, state, batches, step, snap
    return rec


def _lmt_remat_donation(seed, dev):
    """c. At full width, 6 layers, S 2048: gradients with remat against
    without; a donated update (chunked embedding) against a functional one
    with every leaf unchunked, on the same gradients: bitwise."""
    import dataclasses

    import torch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.core.tree import flatten_with_path, leaves, path_name
    from repro_torch.core.tree import unflatten
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch.steps import make_loss_fn, value_and_grad
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.api import init_model
    from repro_torch.optim import adamw
    sp = SparsityConfig(block_shape=(16, 16), sparsity=0.7, lambda_reg=1e-4)
    cfg = dataclasses.replace(_lm_config(), n_layers=LMT_LAYERS, sparsity=sp)
    params = init_model(seed + 1, cfg, device=dev)
    pipe = DataPipeline(DataConfig(seq_len=LMT_SHORT_SEQ, global_batch=1,
                                   vocab_size=cfg.vocab_size))
    batch = {k: torch.from_numpy(v).to(dev, torch.int64)
             for k, v in pipe.batch_at(0).items()}
    pipe.close()
    loss_fn = make_loss_fn(cfg)
    torch.cuda.reset_peak_memory_stats()
    l1, _, g1 = value_and_grad(loss_fn, params, batch)
    peak_remat = torch.cuda.max_memory_allocated()
    remat = lm_mod.checkpoint      # swapped for a plain call: no remat
    lm_mod.checkpoint = lambda fn, *a, use_reentrant, **kw: fn(*a, **kw)
    try:
        torch.cuda.reset_peak_memory_stats()
        l0, _, g0 = value_and_grad(loss_fn, params, batch)
        peak_plain = torch.cuda.max_memory_allocated()
    finally:
        lm_mod.checkpoint = remat
    # the recompute runs the same operations on the same inputs, so the
    # gradients must be bitwise those of plain autograd
    check(torch.equal(l1, l0), f"remat loss {float(l1)!r} vs plain "
          f"{float(l0)!r}")
    for (path, a), b in zip(flatten_with_path(g1), leaves(g0)):
        check(torch.equal(a, b), f"remat gradient {path_name(path)} is not "
              f"bitwise the plain one")
    print(f"[lm_training] c. {LMT_LAYERS} layers, S {LMT_SHORT_SEQ}: loss "
          f"remat {float(l1):.6f} / plain {float(l0):.6f}; gradients with "
          f"remat vs without bitwise equal ({len(leaves(g0))} leaves); peak "
          f"memory of the value_and_grad {peak_remat / 2**30:.2f} GiB with "
          f"remat, {peak_plain / 2**30:.2f} GiB without")
    del g0
    opt = adamw.AdamWConfig()
    biggest = max(p.numel() for p in leaves(params))
    chunk = adamw.CHUNK_ELEMS
    adamw.CHUNK_ELEMS = biggest          # the functional update: unchunked
    try:
        pf, of, mf = adamw.adamw_update(g1, adamw.init_opt_state(params, opt),
                                        params, opt, sp)
    finally:
        adamw.CHUNK_ELEMS = chunk
    pd = unflatten(params, [p.clone() for p in leaves(params)])
    od = adamw.init_opt_state(pd, opt)
    ptrs = [x.data_ptr() for x in leaves(pd) + leaves(od)]
    pd2, od2, md = adamw.adamw_update(g1, od, pd, opt, sp, donate=True)
    check(pd2 is pd and od2 is od
          and [x.data_ptr() for x in leaves(pd) + leaves(od)] == ptrs,
          "the donated update did not write into the given tensors")
    same = all(torch.equal(a, b) for a, b in zip(
        leaves(pf) + leaves(of), leaves(pd) + leaves(od)))
    check(same and torch.equal(mf["grad_norm"], md["grad_norm"]),
          "the donated update differs from the functional one")
    print(f"[lm_training] c. donated update (embedding {biggest} elements in "
          f"chunks of {chunk}) vs functional unchunked update on the same "
          f"gradients: params, m, v and step bitwise equal; same data_ptrs")
    rec = {"remat_bitwise": True,
           "peak_remat_gib": peak_remat / 2**30,
           "peak_plain_gib": peak_plain / 2**30}
    del params, g1, pf, of, pd, od, pd2, od2
    return rec


def _lmt_trainer(seed, dev):
    """d. launch/train.Trainer at full width, 6 layers, S 2048, B 1:
    gradual pruning to 0.7 at 16x16 from step 2 to 6, the prox, a fault at
    step 5 recovered from the step-4 checkpoint."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.pruner import sparsity_report
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.fault_tolerance import (FaultInjector,
                                                     FaultToleranceConfig)
    sp = SparsityConfig(block_shape=(16, 16), sparsity=0.7, lambda_reg=1e-4,
                        start_step=2, end_step=6)
    cfg = dataclasses.replace(_lm_config(), n_layers=LMT_LAYERS, sparsity=sp)
    times = {"save": [], "restore": [], "wait": []}
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(n_steps=8, ckpt_dir=tmp, seed=seed, log_every=1,
                           opt=AdamWConfig(), prune=True,
                           ft=FaultToleranceConfig(checkpoint_every=4))
        inj = FaultInjector(fail_at_steps=(5,))
        tr = Trainer(cfg, tcfg, device=dev, data_cfg=DataConfig(
            seq_len=LMT_SHORT_SEQ, global_batch=1,
            vocab_size=cfg.vocab_size), fault_injector=inj)
        save, restore, wait = tr.save_state, tr.restore_state, tr.store.wait
        host_bytes = []

        def timed(kind, fn):
            def run(*a):
                t0 = time.perf_counter()
                out = fn(*a)
                times[kind].append(time.perf_counter() - t0)
                return out
            return run

        def counted_save(store, step, state):
            host_bytes.append(sum(x.numel() * x.element_size()
                                  for x in leaves(state)))
            return save(store, step, state)
        tr.save_state = timed("save", counted_save)
        tr.restore_state = timed("restore", restore)
        tr.store.wait = timed("wait", wait)
        t0 = time.perf_counter()
        state, hist = tr.fit(resume=False)
        wall = time.perf_counter() - t0
        restarts = tr.supervisor.restarts
    check(restarts == 1, f"Supervisor.restarts = {restarts}, expected 1")
    check(inj.fired == {5}, f"injected faults fired at {inj.fired}")
    check(int(state["opt"]["step"]) == 8,
          f"optimizer step {int(state['opt']['step'])}")
    losses = [loss for _, loss in hist]
    check(all(np.isfinite(losses)), f"Trainer loss {losses}")
    report = sparsity_report(state["params"], sp)
    low, high = min(report.values()), max(report.values())
    print(f"[lm_training] d. Trainer: {len(hist)} steps run for 8 (fault at "
          f"step 5, {restarts} restart from the step-4 checkpoint), wall "
          f"{wall:.1f} s; loss by step "
          f"{[(s, round(x, 4)) for s, x in hist]}")
    print(f"[lm_training] d. checkpoints: {len(times['save'])} saves of "
          f"{host_bytes[0] / 1e9:.2f} GB each, host copy in the call "
          f"{[round(x, 2) for x in times['save']]} s, background writes "
          f"drained in {[round(x, 2) for x in times['wait']]} s, restore "
          f"{[round(x, 2) for x in times['restore']]} s")
    print(f"[lm_training] d. block sparsity of the {len(report)} targeted "
          f"leaves after step 7: min {low:.4f}, max {high:.4f} (target "
          f"{sp.sparsity} +- 0.02)")
    prefix, pattern, _, suffix = cfg.layer_plan()
    n_leaves = 4 * (len(prefix) + len(pattern) + len(suffix))
    check(len(report) == n_leaves and abs(low - 0.7) <= 0.02
          and abs(high - 0.7) <= 0.02, f"block sparsity {report}")
    rec = {"losses": hist, "restarts": restarts, "wall_s": wall,
           "ckpt_gb": host_bytes[0] / 1e9, **times}
    return state["params"], cfg, rec


class _PackedKernelCheck:
    """While a pass runs, holds every K1 output (the forward and the remat
    recompute), K4 dX and K5 tile gradient of the packed projections
    (``exec_plan._PlanLinearPallas``) -- on the step's own X and dY --
    against fp32 products of the same X, dY and the dense weight the tiles
    stand for: Y = X Wᵀ, dX = dY W, and dW = dYᵀ X gathered at the stored
    tiles. Keeps each kernel's worst error in units of the reference's
    max|.| and its number of calls."""

    def __init__(self):
        from repro_torch.kernels import exec_plan
        self.ep = exec_plan
        self.worst = {"K1": 0.0, "K4": 0.0, "K5": 0.0}
        self.calls = dict.fromkeys(self.worst, 0)

    def _hold(self, name, got, ref):
        err = (got.float() - ref).abs().max() / ref.abs().max()
        self.worst[name] = max(self.worst[name], float(err))
        self.calls[name] += 1

    def __enter__(self):
        cls = self.ep._PlanLinearPallas
        self._fwd, self._bwd = (cls.__dict__[k] for k in ("forward",
                                                          "backward"))

        def forward(ctx, x, data_rp, plan):
            y = self._fwd.__func__(ctx, x, data_rp, plan)
            w = _plan_dense(plan, data_rp).float()
            self._hold("K1", y, x.float() @ w.T)
            ctx.held = x, data_rp     # saved_tensors unpack once under remat
            return y

        def backward(ctx, dy):
            dx, ddata, none = self._bwd.__func__(ctx, dy)
            (x, data_rp), plan, dy32 = ctx.held, ctx.plan, dy.float()
            self._hold("K4", dx, dy32 @ _plan_dense(plan, data_rp).float())
            (n, k), (bn, bk) = plan.shape, plan.tile
            dw = (dy32.T @ x.float()).reshape(n // bn, bn, k // bk, bk)
            self._hold("K5", self.ep.unpack_plan_data(plan, ddata),
                       dw.permute(0, 2, 1, 3)[_plan_blocks(plan, dy.device)])
            return dx, ddata, none
        cls.forward, cls.backward = staticmethod(forward), staticmethod(
            backward)
        return self

    def __exit__(self, *exc):
        cls = self.ep._PlanLinearPallas
        cls.forward, cls.backward = self._fwd, self._bwd


def _lmt_serve_and_finetune(params, cfg, seed, dev, counters):
    """e. the trained model to prepare_servable(prune='none', plan_pallas,
    16x16 tiles) and ServingEngine (K1, K2); f. 2 packed fine-tuning steps
    (K1 forward and again in the remat recompute, K4 dX, K5 dW). Returns
    the main path's launch counts."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.kernels import bsr_matmul as bm
    from repro_torch.kernels.flash_decode import decode_kernel_override
    from repro_torch.launch.steps import (make_loss_fn, make_train_step,
                                          value_and_grad)
    from repro_torch.models import api as model_api
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.serving import ServingSpec, prepare_servable
    n_layers, n_global, n_local = _layer_counts(cfg)
    spec = ServingSpec(tile=(16, 16), prune="none", backend="plan_pallas")
    t0 = time.perf_counter()
    servable = prepare_servable(params, cfg, spec, device=dev)
    torch.cuda.synchronize()
    packs = servable.packs
    n_per = cfg.layer_plan()[2]
    k1_pass = sum(n_per if k.startswith("blocks/") else 1 for k in packs)
    st = servable.stats()
    print(f"[lm_training] e. hand-off: prepare_servable(prune='none', "
          f"plan_pallas, tile 16x16) {time.perf_counter() - t0:.1f} s; "
          f"{len(packs)} packed projections "
          f"({sorted({k.split('/', 2)[2] for k in packs})}), density "
          f"{st['density']:.3f}; {k1_pass} K1 launches a forward pass")
    rng = np.random.RandomState(seed + 21)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in LMT_REQUESTS]
    totals = dict.fromkeys(counters, 0)
    eng = servable.engine(max_slots=4, cache_len=1280, sync_every=8)
    eng.submit(prompts[0][:8], max_new_tokens=2)       # warm-up
    eng.run()
    eng.stats = type(eng.stats)()
    torch.cuda.synchronize()
    # --- the counted main-path run: every count set to 0 just before
    for fn in counters.values():
        fn.launches = 0
    handles = [eng.submit(p, max_new_tokens=LM_NEW_TOKENS) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    got = {n: fn.launches for n, fn in counters.items()}
    for n, c in got.items():
        totals[n] += c
    es = eng.stats
    for h in handles:
        check(h.status == "done", f"request {h.req_id} ended {h.status} "
              f"({h.failure})")
    want = dict.fromkeys(counters, 0)
    want.update(plan_dds=k1_pass * (es.steps + es.prefills),
                flash_decode=es.steps * n_layers)
    print(f"[lm_training] e. engine: {len(handles)} greedy requests done, "
          f"{es.tokens_generated} tokens, {es.steps} decode steps, "
          f"{es.prefills} prefills; launches {got} (expected {want}); "
          f"{1e3 * es.decode_s / es.steps:.3f} ms a decode step (host "
          f"clock)")
    check(got == want, "hand-off engine launches differ from the routing")
    del eng, handles
    cache, tok, pos, _ = _prefill_slots(servable, prompts)
    with torch.no_grad():
        with decode_kernel_override("flash"):
            y_k, _ = model_api.decode_step(servable.params, _clone_cache(
                cache), cfg, tok, pos, packs=packs)
        with decode_kernel_override("xla"):
            y_p, _ = model_api.decode_step(servable.params, cache, cfg, tok,
                                           pos, packs=_plain_packs(packs))
    err, scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
    print(f"[lm_training] e. decode_step logits, kernels (K1 + K2) vs the "
          f"plain composition: max|d| {err:.4e}, max|logits| {scale:.4e}, "
          f"tol {TOL_FLASH_VS_XLA * scale:.4e}")
    check(bool(torch.isfinite(y_k).all()) and err <= TOL_FLASH_VS_XLA * scale,
          "hand-off decode_step logits disagree with the plain composition")
    del cache, y_k, y_p

    # f. packed fine-tuning (the prox has nothing to act on in packed
    # values, so the step runs without the sparsity config)
    fcfg = dataclasses.replace(cfg, sparsity=None)
    opt = AdamWConfig()
    sparams, ostate = servable.params, init_opt_state(servable.params, opt)
    pipe = DataPipeline(DataConfig(seq_len=LMT_SHORT_SEQ, global_batch=1,
                                   vocab_size=cfg.vocab_size))
    batches = [{k: torch.from_numpy(v).to(dev, torch.int64)
                for k, v in pipe.batch_at(100 + i).items()}
               for i in range(LMT_PACKED_STEPS)]
    pipe.close()
    m = batches[0]["tokens"].numel()
    with torch.no_grad():
        dense = _unpacked_dense(sparams, packs, cfg)
        ce_dense = float(make_loss_fn(fcfg)(dense, batches[0])[1]["ce"])
        del dense
    step = make_train_step(fcfg, opt, packs=packs)
    k1_remat = sum(n_per for k in packs if k.startswith("blocks/"))
    want = dict.fromkeys(counters, 0)
    want.update(plan_dds=k1_pass + k1_remat, plan_dds_t=k1_pass,
                plan_sddmm=k1_pass)
    p_, o_, first = sparams, ostate, None
    for i, batch in enumerate(batches):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_, o_, met = step(p_, o_, batch)
        loss = float(met["loss"])
        ms = 1e3 * (time.perf_counter() - t0)
        got = {n: fn.launches for n, fn in counters.items()}
        for n, c in got.items():
            totals[n] += c
        first = first or met
        print(f"[lm_training] f. packed step {i}: loss {loss:.6f}, "
              f"grad_norm {float(met['grad_norm']):.6f}, {ms:.1f} ms (host "
              f"clock), launches {got} (expected {want}: K1 forward + the "
              f"remat recompute of the period's packs, one K4 and one K5 a "
              f"packed projection)")
        check(np.isfinite(loss), f"packed step {i}: loss {loss}")
        check(got == want, f"packed step {i}: launches differ from the "
              f"routing")
    rel = abs(float(first["ce"]) - ce_dense) / abs(ce_dense)
    print(f"[lm_training] f. first packed step's cross-entropy "
          f"{float(first['ce']):.6f} vs the dense forward of the unpacked "
          f"weights {ce_dense:.6f}: rel {rel:.3e} (tol {TOL_PACKED_DENSE}; "
          f"a weak check: the attention of a random model falls below "
          f"bf16's resolution of the residual stream)")
    check(rel <= TOL_PACKED_DENSE, "packed loss disagrees with the dense one")
    # the kernels held inside the step at the main path's shape (M = m, bf16,
    # 16x16 tiles): a gradient pass over the first batch
    with _PackedKernelCheck() as held:
        _, _, grads = value_and_grad(make_loss_fn(fcfg, packs), sparams,
                                     batches[0])
    print(f"[lm_training] f. inside a packed step at M {m}, each kernel's "
          f"output vs fp32 products of the same bf16 X, dY and tiles "
          f"(dW gathered at the stored tiles): worst "
          f"{ {k: f'{e:.3e}' for k, e in held.worst.items()} } of the "
          f"reference's max|.| (tol {TOL_PACKED_KERNEL:.3e}) over "
          f"{held.calls} calls")
    check(held.calls == {"K1": k1_pass + k1_remat, "K4": k1_pass,
                         "K5": k1_pass}, "the held kernel calls differ "
          "from the routing")
    check(all(e <= TOL_PACKED_KERNEL for e in held.worst.values()),
          "a packed kernel disagrees with the fp32 dense product")
    dead = 0
    for key, pk in packs.items():
        _, i, group, name = key.split("/")
        mask = torch.from_numpy(~pk.plan.slot_mask).to(dev)
        for tree in (grads, p_):
            pad = tree["blocks"][int(i)][group][name]["w"][:, mask]
            check(bool((pad == 0).all()), f"{key}: a padding slot's "
                  f"gradient or value is not 0")
        dead += int(mask.sum()) * n_per
    tile = next(iter(packs.values())).plan.tile
    print(f"[lm_training] f. padding slots: {dead} of the packed values' "
          f"slots, gradients exactly 0 and values still 0 after "
          f"{LMT_PACKED_STEPS} steps; bf16 M {m} tile {tile}: K4 instance "
          f"{bm.dds_instance(m, tile, torch.bfloat16, True)}, K5 instance "
          f"{bm.sddmm_instance(m, tile, torch.bfloat16)}")
    del servable, sparams, ostate, p_, o_, grads, step
    return totals, {"kernel_worst": held.worst, "kernel_calls": held.calls}


def _lmt_families(seed, dev):
    """g. One train step of every other LM family at its smoke size (fp32)
    on the card against the same step on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import map_with_path
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import init_model
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for arch in TRAIN_FAMILIES:
        cfg = get_config(arch, smoke=True)
        check(cfg.dtype == "float32", f"{arch} smoke is {cfg.dtype}")
        rng = np.random.RandomState(seed + 31)
        b = {"tokens": rng.randint(0, cfg.vocab_size, (2, 32)),
             "labels": rng.randint(0, cfg.vocab_size, (2, 32))}
        if cfg.family == "audio":
            b["frames"] = rng.randn(2, cfg.n_audio_ctx, cfg.d_model)
        if cfg.family == "vlm":
            b["mm_embeds"] = rng.randn(2, cfg.n_patches, cfg.d_model)
        step = make_train_step(cfg, opt)
        res = {}
        for where in ("cpu", "cuda"):
            p = init_model(seed, cfg, device="cpu")
            p = map_with_path(lambda _, x: x.to(where), p)
            batch = {k: torch.from_numpy(v).to(
                where, torch.int64 if v.dtype.kind == "i" else torch.float32)
                for k, v in b.items()}
            _, _, met = step(p, init_opt_state(p, opt), batch)
            res[where] = (float(met["loss"]), float(met["grad_norm"]))
        rel = [abs(a - c) / abs(c) for a, c in zip(res["cuda"], res["cpu"])]
        print(f"[lm_training] g. {arch} ({cfg.family}) smoke step: loss "
              f"card {res['cuda'][0]:.7f} / cpu {res['cpu'][0]:.7f}, "
              f"grad_norm card {res['cuda'][1]:.7f} / cpu "
              f"{res['cpu'][1]:.7f}; rel {rel[0]:.2e}, {rel[1]:.2e} (tol "
              f"{TOL_FAMILY_STEP})")
        check(all(np.isfinite(res["cuda"])) and max(rel) <= TOL_FAMILY_STEP,
              f"{arch}: the card's step differs from the CPU's")
        out[arch] = {"card": res["cuda"], "cpu": res["cpu"], "rel": rel}
    return out


def phase_lm_training(seed: int, card: str):
    """LM training on the card: a. the flash-attention backward; b. one
    gemma3_4b step at full width and depth; c. remat and donation; d. the
    Trainer loop; e. the hand-off to K1 / K2 serving; f. packed fine-tuning
    through K1, K4 and K5; g. every other LM family's step against the
    CPU. The main path's launches (e, f) are returned."""
    import gc

    import torch
    from repro_torch.kernels import bsr_matmul as bm
    from repro_torch.kernels import plan_dds
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"plan_dds": plan_dds, "flash_decode": flash_decode,
                "paged_flash_decode": paged_flash_decode, "dds": bm.dds,
                "dds_t": bm.dds_t, "plan_dds_t": bm.plan_dds_t,
                "sddmm": bm.sddmm, "plan_sddmm": bm.plan_sddmm}
    rec, marks = {}, [time.perf_counter()]

    def part(name):
        gc.collect()
        torch.cuda.empty_cache()
        marks.append(time.perf_counter())
        print(f"[lm_training] {name}: {marks[-1] - marks[-2]:.1f} s")

    rec["flash"] = _lmt_flash(dev)
    part("a")
    rec["full_depth"] = _lmt_full_depth(seed, dev, card)
    part("b")
    rec["remat"] = _lmt_remat_donation(seed, dev)
    part("c")
    params, cfg, rec["trainer"] = _lmt_trainer(seed, dev)
    part("d")
    launches, rec["packed"] = _lmt_serve_and_finetune(params, cfg, seed, dev,
                                                      counters)
    del params
    part("e, f")
    rec["families"] = _lmt_families(seed, dev)
    part("g")
    print(f"[lm_training] summary {json.dumps(rec, default=str)}")
    return launches


# --------------------------------------------------------------------------
# phase 4f: lm_tp -- mesh serving over ranks that share the card (gloo)
# --------------------------------------------------------------------------

#: (partition, mesh shape, backend, KV layouts) of gemma3_4b's mesh runs
LM_TP_PARTITIONS = (("tp", (1, 4), "plan", ("dense", "paged")),
                    ("dp", (4, 1), "plan_pallas", ("dense",)),
                    ("tp+dp", (2, 2), "plan", ("dense",)))
BERT_TP_MESHES = ((1, 4), (1, 2))
#: gemma3_4b's mesh traffic: lm_serving's first two prompts, 4 new tokens
#: each (cut from 4 x 8 to fit lm_tp_recurrent in the run's time limit;
#: the decode_step logits' four slots are prefills of the two prompts)
LM_TP_PROMPTS = LM_PROMPTS[:2]
LM_TP_NEW_TOKENS = 4
#: seconds one rank may spend on one job (and the collectives' timeout)
LM_TP_JOB_S = 600
LM_TP_KERNELS = ("plan_dds", "flash_decode", "paged_flash_decode")


def _rank_shapes(cache):
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.launch.sharding import leaf_name
    return {leaf_name(p): tuple(x.shape) for p, x in flatten_with_path(cache)}


def _launch_counts():
    from repro_torch.kernels import plan_dds
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)
    return {"plan_dds": plan_dds.launches,
            "flash_decode": flash_decode.launches,
            "paged_flash_decode": paged_flash_decode.launches}


def _zero_launches():
    from repro_torch.kernels import plan_dds
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)
    plan_dds.launches = 0
    flash_decode.launches = 0
    paged_flash_decode.launches = 0


def _tp_decode_logits(sv, prompts, cache_len=1280, frames=None,
                      tokens=None):
    """decode_step logits (4, V) fp32 of a 4-slot cache holding each prompt
    (one-shot prefill, as the engine admits; an audio prompt into the
    batch-1 cache of its ``frames``) at the next tokens ``tokens`` (by
    default the greedy ones at the prompts' ends) -- the same calls on one
    device and on a mesh, given the same tokens: a near-tie in a prefill
    row would otherwise feed the two sides different tokens. Returns
    (logits, host ms of the step, the greedy tokens of the prefills)."""
    import numpy as np
    import torch
    dev = sv.device
    audio = frames is not None
    if audio:
        cfg = sv.cfg
        cache = sv.init_cache(4, cache_len, frames=torch.zeros(
            (4, cfg.n_audio_ctx, cfg.d_model), dtype=cfg.tdtype, device=dev))
    else:
        cache, sub = sv.init_cache(4, cache_len), sv.init_cache(1, cache_len)
    toks, posl = [], []
    for slot, p in enumerate(prompts):
        if audio:
            sub = sv.init_cache(1, cache_len, frames=frames[slot][None])
        bucket = min(cache_len, 1 << (len(p) - 1).bit_length())
        padded = np.zeros((bucket,), np.int32)
        padded[:len(p)] = p
        sub, row = sv.prefill_row(sub, torch.from_numpy(padded).to(dev),
                                  len(p))
        sv.engine_write_slot(cache, slot, sub, batch=4)
        toks.append(int(torch.argmax(row)))
        posl.append(len(p))
    tok = torch.tensor(toks if tokens is None else list(tokens),
                       dtype=torch.int32, device=dev)[:, None]
    pos = torch.tensor(posl, dtype=torch.int32, device=dev)
    if sv.mesh is not None:
        sv.mesh.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = sv.decode_step(cache, tok, pos)
    torch.cuda.synchronize()
    return logits[:, 0].float(), (time.perf_counter() - t0) * 1e3, toks


def _whole_cache(cfg, batch, cache_len, paged=None):
    """A whole decode cache's leaves on the meta device (shapes only)."""
    if cfg.family == "audio":
        from repro_torch.models import encdec
        return encdec.cache_like(cfg, cfg.n_layers, batch, cache_len,
                                  cfg.n_audio_ctx)
    from repro_torch.models import lm
    return lm.init_cache(cfg, batch, cache_len, paged=paged, device="meta")


#: the cache leaves a rank reports by name, the first of them (by suffix)
#: the one its engine-run line shows
_RANK_LEAVES = ("mix/k_pages", "mix/k", "mix/c_kv_pages", "mix/c_kv",
                "mix/state", "mix/conv", "mix/h", "cross_k", "cross_v",
                "self/k")


def _rank_lm_job(job):
    """A rank's LM run: place its shard of the whole export the parent
    shares (CUDA IPC; the shards stay views of the parent's leaves), then
    for each KV layout a warm-up request and the counted engine run over
    the job's traffic, then decode_step logits on 4 prefilled slots. A
    family job also runs the vlm forward against the
    parent's logits (``job['vlm']``), logs every MoE routing call of the
    logits step (rank 0 returns it) and reports its expert and latent
    shards. An audio job hands every rank each request's frames
    (``job['frames']``, ``job['logit_frames']``); ``job['cache_len']``
    sets the engine's cache (1280 by default), ``job['warm_up']`` False
    skips the warm-up request."""
    import gc
    import torch
    from repro_torch.core.pattern_reuse import PatternRegistry
    from repro_torch.launch.sharding import shard_shape, spec_for_cache
    from repro_torch.serving import Servable, place_servable
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    params, cfg, spec, packs, stats = job.pop("servable")
    t0 = time.perf_counter()
    sv = place_servable(Servable(params, cfg, spec, packs, PatternRegistry(),
                                 dev, export_stats=stats))
    del params, packs
    torch.cuda.synchronize()
    mesh = sv.mesh
    out = {"coord": mesh.coordinate, "place_s": time.perf_counter() - t0,
           "sharding": sv.stats()["sharding"], "runs": {},
           "shards": _rank_family_shards(sv)}
    say = _rank_say(mesh.rank, job["name"], job.get("phase", "lm_tp"))
    say(f"placed in {out['place_s']:.1f} s")
    if "vlm" in job:
        toks, mm, ref = job.pop("vlm")
        y = sv.forward({"tokens": toks, "mm_embeds": mm})
        torch.cuda.synchronize()
        out["vlm"] = {"err": float((y - ref).abs().max()),
                      "scale": float(ref.abs().max()),
                      "finite": bool(torch.isfinite(y).all())}
        del y, ref
    prompts = job["prompts"]
    cache_len = job.get("cache_len", 1280)
    frames = job.get("frames") or [None] * len(prompts)

    def extra(f):
        return {} if f is None else {"frames": f}

    def want_shapes(batch, paged=None):
        whole = _whole_cache(cfg, batch, cache_len, paged)
        return {n: shard_shape(sh, spec_for_cache(n, sh, mesh), mesh)
                for n, sh in _rank_shapes(whole).items()}
    for i, layout in enumerate(job["layouts"]):
        eng = sv.engine(max_slots=4, cache_len=cache_len, sync_every=8,
                        kv_layout=layout)
        if i == 0 and job.get("warm_up", True):
            eng.submit(prompts[0][:8], max_new_tokens=2,
                       **extra(frames[0]))                  # warm-up
            eng.run()
            say(f"{layout}: warm-up done")
        eng.stats = type(eng.stats)()
        want = want_shapes(4, eng._layout)
        before = _rank_shapes(eng.cache)
        torch.cuda.synchronize()
        # --- the counted main-path run: every count set to 0 just before
        mesh.reset_stats()
        _zero_launches()
        t0 = time.perf_counter()
        with _RouterLog() as run_log:
            hs = [eng.submit(p, max_new_tokens=job["n_new"], **extra(f))
                  for p, f in zip(prompts, frames)]
            eng.run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _launch_counts()
        es = eng.stats
        say(f"{layout}: counted run {wall:.1f} s (prefill "
            f"{es.prefill_s:.1f} s, decode {es.decode_s:.1f} s)")
        k_leaf = next(n for n in before if n.endswith(_RANK_LEAVES))
        out["runs"][layout] = {
            "layout": eng.kv_layout, "launches": got,
            "tokens": [list(h.tokens) for h in hs],
            "status": [f"{h.status} {h.failure or ''}".strip() for h in hs],
            "steps": es.steps, "prefills": es.prefills,
            "windows": es.windows, "decode_s": es.decode_s,
            "prefill_s": es.prefill_s, "wall_s": wall,
            "collectives": copy.deepcopy(mesh.stats),
            "cache_follows_spec": before == want,
            "cache_kept_shapes": _rank_shapes(eng.cache) == before,
            "sub_follows_spec": _rank_shapes(eng._sub) == want_shapes(1),
            "k_leaf": (k_leaf, before[k_leaf]),
            "leaves": {n: sh for n, sh in before.items()
                       if n.endswith(_RANK_LEAVES)},
            "buckets": dict(es.bucket_hits),
            "routing": (run_log.to_host() if mesh.rank == 0
                        and run_log.calls else None)}
        del eng, run_log
    with _RouterLog() as log:
        logits, ms, out["prefill_tokens"] = _tp_decode_logits(
            sv, job.get("logit_prompts", job["prompts"])[:4], cache_len,
            job.get("logit_frames"), job.get("logit_tokens"))
    out["logit_tokens"] = job.get("logit_tokens") or out["prefill_tokens"]
    out["step_collectives"] = copy.deepcopy(mesh.stats)
    out["decode_step_ms"] = ms
    out["decode_sum"] = float(logits.double().sum())
    if mesh.rank == 0:
        out["decode_logits"] = logits.cpu().numpy()
        if log.calls:
            out["routing"] = log.to_host()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del sv, logits, log
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rank_family_shards(sv):
    """This rank's routed-expert and latent-cache shards: every routed
    expert leaf's local shape and bytes (a view counts its own elements),
    and the local ``c_kv`` width of a one-slot cache."""
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.launch.sharding import leaf_name
    from repro_torch.serving.servable import _routed_expert
    experts = {leaf_name(p): (tuple(x.shape), x.numel() * x.element_size())
               for p, x in flatten_with_path(sv.params)
               if _routed_expert(leaf_name(p), x.dim())}
    latent = None
    if sv.cfg.kv_lora_rank:
        cache = _rank_shapes(sv.init_cache(1, 16))
        latent = {n: sh for n, sh in cache.items() if n.endswith("c_kv")}
    return {"experts": experts, "latent": latent}


def _rank_say(rank, name, phase="lm_tp"):
    """Rank 0's progress lines (flushed: the parent waits on the ranks)."""
    t0 = time.perf_counter()

    def say(msg):
        if rank == 0:
            print(f"[{phase}] rank 0, {name}: {msg} "
                  f"(+{time.perf_counter() - t0:.1f} s)", flush=True)
    return say


def _rank_collectives(job):
    """ms per all_reduce and all_gather over the world's gloo group, for
    CUDA and for CPU tensors of three sizes: the cost every mesh step pays
    (a reading)."""
    import torch
    import torch.distributed as dist
    out = {}
    for dev in ("cuda", "cpu"):
        for n in (1024, 262144, 22 * 2**20):
            x = torch.ones(n, dtype=torch.float32, device=dev)
            reps = 50 if n <= 262144 else 5
            dist.all_reduce(x)
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                dist.all_reduce(x)
            if dev == "cuda":
                torch.cuda.synchronize()
            out[f"all_reduce {dev} {4 * n} B"] = \
                (time.perf_counter() - t0) * 1e3 / reps
            parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, x)
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                dist.all_gather(parts, x)
            if dev == "cuda":
                torch.cuda.synchronize()
            out[f"all_gather {dev} {4 * n} B a rank"] = \
                (time.perf_counter() - t0) * 1e3 / reps
    return out


def _rank_bert_job(job):
    """A rank's BERT-base run: load its shard of the saved export (memory
    mapped), the serving traffic against the single-device logits the
    parent shares (CUDA IPC)."""
    import gc
    import torch
    from repro_torch.serving import load_servable
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sv = load_servable(job["path"], device=dev)
    out = {"load_s": time.perf_counter() - t0,
           "sharding": sv.stats()["sharding"], "errs": [], "scales": [],
           "sums": [], "ms": []}
    sv.forward(job["reqs"][0])                           # warm-up
    for toks, ref in zip(job["reqs"], job["refs"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = sv.forward(toks)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["errs"].append(float((y - ref).abs().max()))
        out["scales"].append(float(ref.abs().max()))
        out["sums"].append(float(y.double().sum()))
        out["finite"] = bool(torch.isfinite(y).all())
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del sv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rank_gloo_probe(job):
    """What gloo takes on CUDA tensors: each collective on a group of its
    own with a 20 s timeout, its outcome recorded (a reading, not a
    check)."""
    import datetime
    import torch
    import torch.distributed as dist
    g = dist.new_group(list(range(dist.get_world_size())),
                       timeout=datetime.timedelta(seconds=20))
    n = dist.get_world_size()

    def t(dtype):
        return torch.ones(8, dtype=dtype, device="cuda")
    probes = (
        ("all_reduce float32", lambda: dist.all_reduce(t(torch.float32),
                                                       group=g)),
        ("all_reduce int32", lambda: dist.all_reduce(t(torch.int32),
                                                     group=g)),
        ("all_reduce int64", lambda: dist.all_reduce(t(torch.int64),
                                                     group=g)),
        ("broadcast float32", lambda: dist.broadcast(t(torch.float32), 0,
                                                     group=g)),
        ("all_reduce bfloat16", lambda: dist.all_reduce(t(torch.bfloat16),
                                                        group=g)),
        ("all_gather float32", lambda: dist.all_gather(
            [t(torch.float32) for _ in range(n)], t(torch.float32),
            group=g)),
        ("all_gather_into_tensor float32",
         lambda: dist.all_gather_into_tensor(
             torch.empty(8 * n, device="cuda"), t(torch.float32), group=g)))
    res = {}
    for name, fn in probes:
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:  # noqa: BLE001 -- the reading itself
            res[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return res


def _rank_cards_job(job):
    """A rank on a card of its own (NCCL): gemma3_4b from the seed, pruned,
    this rank's shard of the tp (1, 4) export; lm_serving's traffic; rank
    0 also serves the same export whole on its card, the reference."""
    import dataclasses
    import gc
    import torch
    from repro_torch.core.pruner import tied_prune
    from repro_torch.models.api import init_model
    from repro_torch.serving import ServingSpec, prepare_servable
    dev = torch.device("cuda")
    cfg = _lm_config()
    spec = ServingSpec(**job["spec"])
    params = init_model(job["seed"], cfg, device=dev)
    pruned, _ = tied_prune(params, spec.sparsity_config())
    del params
    spec = dataclasses.replace(spec, prune="none", mesh_shape=(1, 4),
                               partition="tp")
    torch.cuda.reset_peak_memory_stats()
    sv = prepare_servable(pruned, cfg, spec, device=dev)
    mesh = sv.mesh
    say = _rank_say(mesh.rank, job["name"])
    prompts = job["prompts"]

    def serve(s):
        eng = s.engine(max_slots=4, cache_len=1280, sync_every=8)
        eng.submit(prompts[0][:8], max_new_tokens=2)         # warm-up
        eng.run()
        eng.stats = type(eng.stats)()
        torch.cuda.synchronize()
        if s.mesh is not None:
            s.mesh.reset_stats()
        _zero_launches()
        t0 = time.perf_counter()
        hs = [eng.submit(p, max_new_tokens=job["n_new"]) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        es = eng.stats
        return {"tokens": [list(h.tokens) for h in hs],
                "status": [h.status for h in hs],
                "launches": _launch_counts(), "steps": es.steps,
                "prefills": es.prefills, "decode_s": es.decode_s,
                "prefill_s": es.prefill_s,
                "wall_s": time.perf_counter() - t0}

    out = {"mesh": serve(sv), "coord": mesh.coordinate,
           "collectives": copy.deepcopy(mesh.stats)}
    say("mesh run done")
    logits, out["decode_step_ms"], toks = _tp_decode_logits(sv,
                                                             prompts[:4])
    out["step_collectives"] = copy.deepcopy(mesh.stats)
    out["decode_sum"] = float(logits.double().sum())
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del sv
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        one = prepare_servable(pruned, cfg, spec, device=dev, place=False)
        out["one"] = serve(one)
        ref, _, _ = _tp_decode_logits(one, prompts[:4], tokens=toks)
        out["gap"] = float((logits - ref).abs().max())
        out["scale"] = float(ref.abs().max())
        out["margins"] = []
        for r, i in _first_differences(out["one"]["tokens"],
                                       out["mesh"]["tokens"]):
            seq = list(prompts[r]) + out["one"]["tokens"][r][:i]
            row = one.forward(np.asarray(seq, np.int32)[None])[0, -1]
            top2 = torch.topk(row.float(), 2).values
            out["margins"].append((r, i, float(top2[0] - top2[1])))
        del one
        say("single-card run done")
    return out


def _trace_layers(sv, prompt):
    """The residual after every layer of a one-pass prefill of ``prompt``
    into a batch-1 cache and of the decode step after it, fed ``token``
    (host fp32 copies)."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    rec = []
    orig = lm._apply_layer

    def hook(*a, **k):
        h, aux = orig(*a, **k)
        rec.append(h.detach().float().cpu())
        return h, aux
    dev = sv.device
    sub = sv.init_cache(1, 1280)
    padded = np.zeros((1 << (len(prompt["tokens"]) - 1).bit_length(),),
                      np.int32)
    padded[:len(prompt["tokens"])] = prompt["tokens"]
    lm._apply_layer = hook
    try:
        sub, _ = sv.prefill_row(sub, torch.from_numpy(padded).to(dev),
                                len(prompt["tokens"]))
        n_pre = len(rec)
        sv.decode_step(sub, torch.tensor([[prompt["next"]]], dtype=torch.int32,
                                         device=dev),
                       torch.tensor([len(prompt["tokens"])],
                                    dtype=torch.int32, device=dev))
    finally:
        lm._apply_layer = orig
    return rec[:n_pre], rec[n_pre:]


def _rank_trace_job(job):
    """A rank's per-layer residual trace (rank 0 returns it)."""
    import torch
    from repro_torch.core.pattern_reuse import PatternRegistry
    from repro_torch.serving import Servable, place_servable
    params, cfg, spec, packs, stats = job.pop("servable")
    sv = place_servable(Servable(params, cfg, spec, packs, PatternRegistry(),
                                 torch.device("cuda"), export_stats=stats))
    out = _trace_layers(sv, job["prompt"])
    return out if sv.mesh.rank == 0 else None


_RANK_JOBS = {"lm": _rank_lm_job, "bert": _rank_bert_job,
              "probe": _rank_gloo_probe, "collectives": _rank_collectives,
              "cards": _rank_cards_job, "trace": _rank_trace_job}


def phase_lm_tp_cards(seed: int, card: str):
    """gemma3_4b over tp (1, 4) with one card a rank (NCCL), against the
    same export on one card: the mesh path across real cards (run it on a
    four-card machine: ``--phases lm_tp_cards``)."""
    import numpy as np
    import torch
    n = torch.cuda.device_count()
    check(n >= 4, f"lm_tp_cards needs four cards, this machine has {n}")
    cfg = _lm_config()
    n_layers = _layer_counts(cfg)[0]
    rng = np.random.RandomState(seed + 2)
    prompts = [rng.randint(0, cfg.vocab_size, k).tolist() for k in LM_PROMPTS]
    spec = dict(tile=(128, 128), sparsity=0.8, prune="tied", fuse_qkv=True,
                decode_kernel="flash", backend="plan")
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _Ranks(4, tmp, "nccl")
        try:
            res = ranks.run({"name": "cards", "kind": "cards", "seed": seed,
                             "spec": spec, "prompts": prompts,
                             "n_new": LM_NEW_TOKENS})
        finally:
            ranks.close()
    counts = {k: 0 for k in LM_TP_KERNELS}
    one = res[0]["one"]
    for r in res:
        run = r["mesh"]
        check(all(s == "done" for s in run["status"]),
              f"rank {r['coord']}: {run['status']}")
        want = {"plan_dds": 0, "flash_decode": run["steps"] * n_layers,
                "paged_flash_decode": 0}
        check(run["launches"] == want, f"rank {r['coord']}: launches "
              f"{run['launches']} differ from the routing {want}")
        check(run["tokens"] == res[0]["mesh"]["tokens"],
              "the ranks' tokens differ")
        check(r["decode_sum"] == res[0]["decode_sum"],
              "the ranks' decode logits differ")
        for k in LM_TP_KERNELS:
            counts[k] += run["launches"][k]
    run = res[0]["mesh"]
    agree = sum(a == b for x, y in zip(one["tokens"], run["tokens"])
                for a, b in zip(x, y))
    gap, scale = res[0]["gap"], res[0]["scale"]
    coll = res[0]["collectives"]
    sc = res[0]["step_collectives"]
    print(f"[lm_tp_cards] {card} x {n}: tp (1, 4) over NCCL, one card a "
          f"rank: {len(run['tokens'])} requests done, {run['steps']} decode "
          f"steps, launches a rank {run['launches']} (= the routing); "
          f"greedy tokens equal to one card's: {agree} of "
          f"{sum(len(x) for x in one['tokens'])}")
    print(f"[lm_tp_cards] host clock: {1e3 * run['decode_s'] / run['steps']:.2f}"
          f" ms a decode step on 4 cards, {1e3 * one['decode_s'] / one['steps']:.2f}"
          f" on one (the same export whole, plain 'plan' composition); "
          f"prefill {run['prefill_s']:.2f} s vs {one['prefill_s']:.2f} s; "
          f"collectives in the run "
          f"{sum(v['calls'] for v in coll.values())} "
          f"({sum(v['bytes'] for v in coll.values()) / 2**20:.1f} MiB, "
          f"{sum(v['s'] for v in coll.values()):.2f} s); one decode step "
          f"{res[0]['decode_step_ms']:.2f} ms, "
          f"{sum(v['calls'] for v in sc.values())} collectives; peak memory "
          f"a rank {[round(r['peak_gib'], 2) for r in res]} GiB")
    print(f"[lm_tp_cards] decode_step logits vs one card max|d| {gap:.4e}, "
          f"max|logits| {scale:.4e} (tol {TOL_FLASH_VS_XLA * scale:.4e}); "
          f"near-tie margins at differing tokens {res[0]['margins']}")
    check(gap <= TOL_FLASH_VS_XLA * scale, "mesh logits disagree")
    for r, i, margin in res[0]["margins"]:
        check(margin < 2 * gap, f"request {r} token {i} differs where the "
              f"top-2 margin {margin:.4e} is >= 2 x {gap:.4e}")
    return counts


def _lm_tp_rank(rank, world, init, inq, outq, backend):
    """One rank of a mesh: join the process group -- gloo with every rank
    on card 0, or NCCL with rank r on card r -- then run each job the
    parent sends until it sends None."""
    sys.path.insert(0, SRC)
    import traceback
    import torch
    # one host thread a rank: the ranks' work is on the card, and spare
    # intra-op threads spinning on the host's cores starve gloo's
    torch.set_num_threads(1)
    try:
        from repro_torch.launch.mesh import (destroy_distributed,
                                             init_distributed)
        torch.cuda.set_device(rank if backend == "nccl" else 0)
        init_distributed(backend, init, rank, world, timeout_s=LM_TP_JOB_S)
        while True:
            job = inq.get()
            if job is None:
                break
            outq.put((rank, job["name"], _RANK_JOBS[job["kind"]](job)))
        destroy_distributed()
    except BaseException:   # noqa: BLE001 -- reported to the parent
        outq.put((rank, "error", traceback.format_exc()))


class _Ranks:
    """``world`` rank processes (spawned) and their job queues; every job is
    sent to every rank and the phase waits for all of their answers."""

    def __init__(self, world, tmp, backend="gloo"):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        init = "file://" + os.path.join(tmp, f"init_{world}")
        self.outq = ctx.Queue()
        self.inqs = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=_lm_tp_rank,
                                  args=(r, world, init, self.inqs[r],
                                        self.outq, backend), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, job, timeout=LM_TP_JOB_S):
        import queue
        for q in self.inqs:
            q.put(dict(job))
        res = {}
        deadline = time.perf_counter() + timeout
        while len(res) < len(self.procs):
            try:
                rank, name, out = self.outq.get(timeout=5.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(self.procs)
                        if not p.is_alive()]
                if dead:
                    raise PhaseError(f"lm_tp: job {job['name']}: ranks "
                                     f"exited (rank, code) {dead}")
                if time.perf_counter() > deadline:
                    raise PhaseError(
                        f"lm_tp: job {job['name']} got no answer from ranks "
                        f"{sorted(set(range(len(self.procs))) - set(res))} "
                        f"in {timeout} s")
                continue
            if name == "error":
                raise PhaseError(f"lm_tp: rank {rank} failed:\n{out}")
            res[rank] = out
        return [res[r] for r in range(len(self.procs))]

    def close(self):
        for q in self.inqs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


def _first_differences(ref, got):
    """[(request, index)] of each request's first differing token."""
    out = []
    for r, (a, b) in enumerate(zip(ref, got)):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is not None:
            out.append((r, i))
    return out


def _near_tie_check(label, ref_sv, prompts, ref_tokens, diffs, gap,
                    frames=None):
    """A token that differs from the single-device run passes only where
    the single-device top-2 logit margin at that position is below twice
    the decode logits' max |difference| (a near tie). An audio request's
    forward takes its ``frames``. Returns the margins."""
    import numpy as np
    import torch
    margins = []
    for r, i in diffs:
        seq = np.asarray(list(prompts[r]) + list(ref_tokens[r][:i]),
                         np.int32)[None]
        batch = seq if frames is None else {"tokens": seq,
                                            "frames": frames[r][None]}
        logits = ref_sv.forward(batch)[0, -1]
        top2 = torch.topk(logits.float(), 2).values
        margin = float(top2[0] - top2[1])
        print(f"{label}: request {r} first differs at token {i}: "
              f"single-device top-2 margin {margin:.4e}, decode logits "
              f"max|d| {gap:.4e}")
        check(margin < 2 * gap, f"{label}: request {r} token {i} differs "
              f"where the top-2 margin {margin:.4e} is >= 2 x {gap:.4e}")
        margins.append(margin)
    return margins


def phase_lm_tp(seed: int, card: str, n_requests: int):
    """gemma3_4b at full width and depth over tp (1, 4) dense and paged KV,
    dp (4, 1) through kernel K1 and tp+dp (2, 2), one process per mesh
    position on the one card (gloo), against the same export served on
    one device; BERT-base over (1, 4) and (1, 2) from saved exports; what
    gloo takes on CUDA tensors; K2 at a rank's decode shape."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pruner import tied_prune
    from repro_torch.models.api import init_model
    from repro_torch.serving import ServingSpec, prepare_servable
    dev = torch.device("cuda")
    cfg = _lm_config()
    n_layers, n_global, n_local = _layer_counts(cfg)
    print(f"[lm_tp] {cfg.arch}: {n_layers} layers ({n_local} local, "
          f"{n_global} global), {cfg.n_heads} query / {cfg.n_kv_heads} KV "
          f"heads of {cfg.head_dim}; {card}; ranks share the card through "
          f"gloo, so their step times say nothing of tensor-parallel speed")
    base = dict(tile=(128, 128), sparsity=0.8, fuse_qkv=True,
                decode_kernel="flash")
    t0 = time.perf_counter()
    params = init_model(seed, cfg, device=dev)
    pruned, _ = tied_prune(params, ServingSpec(**base).sparsity_config())
    del params
    whole = {}
    for part, shape, backend, _ in LM_TP_PARTITIONS:
        whole[part] = prepare_servable(
            pruned, cfg, ServingSpec(**base, prune="none", backend=backend,
                                     mesh_shape=shape, partition=part),
            device=dev, place=False)
    del pruned
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"[lm_tp] init + prune + three sharded exports (place=False) "
          f"{time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # every packed projection of a layer is one K1 launch a pass (dp)
    k1_per_pass = sum(cfg.layer_plan()[2] if k.startswith("blocks/") else 1
                      for k in next(iter(whole.values())).packs)
    rng = np.random.RandomState(seed + 2)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in LM_TP_PROMPTS]
    logit_prompts = [prompts[0], prompts[1][:64], prompts[1],
                     prompts[0][:20]]
    print(f"[lm_tp] traffic cut to {len(LM_TP_PROMPTS)} requests of "
          f"{LM_TP_PROMPTS} prompt tokens x {LM_TP_NEW_TOKENS} new tokens "
          f"(lm_serving's {len(LM_PROMPTS)} x {LM_NEW_TOKENS}), no warm-up, "
          f"to fit lm_tp_families and lm_tp_recurrent in the run's time "
          f"limit: gloo costs 3-7 ms a collective")

    # the single-device runs: the same exports on this one process
    t0 = time.perf_counter()
    refs, ref_logits, ref_tokens = {}, {}, {}
    for part, _, _, layouts in LM_TP_PARTITIONS:
        for layout in layouts:
            eng = whole[part].engine(max_slots=4, cache_len=1280,
                                     sync_every=8, kv_layout=layout)
            hs = [eng.submit(p, max_new_tokens=LM_TP_NEW_TOKENS)
                  for p in prompts]
            eng.run()
            check(all(h.status == "done" for h in hs),
                  f"{part} {layout}: a single-device request failed")
            refs[(part, layout)] = [list(h.tokens) for h in hs]
            del eng
        ref_logits[part], _, ref_tokens[part] = _tp_decode_logits(
            whole[part], logit_prompts)
    print(f"[lm_tp] single-device runs of the same exports "
          f"{time.perf_counter() - t0:.1f} s")

    # BERT-base exports, saved for the ranks to load
    bcfg = get_config("bert_base")
    bspec = dict(tile=(128, 128), sparsity=0.8, prune="tied", fuse_qkv=True,
                 cross_layer_union=True, backend="plan")
    brng = np.random.RandomState(seed)
    breqs = [torch.from_numpy(brng.randint(0, bcfg.vocab_size, (1, 384))).to(
        dev) for _ in range(n_requests)]
    breqs.append(torch.from_numpy(brng.randint(0, bcfg.vocab_size,
                                               (8, 384))).to(dev))
    bparams = init_model(seed, bcfg, device=dev)
    counts = {k: 0 for k in LM_TP_KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        bert_jobs = {}
        for shape in BERT_TP_MESHES:
            bsv = prepare_servable(bparams, bcfg, ServingSpec(
                **bspec, mesh_shape=shape), device=dev, place=False)
            path = os.path.join(tmp, f"bert_{shape[0]}x{shape[1]}")
            bsv.save(path)
            bert_jobs[shape] = {"name": f"bert {shape}", "kind": "bert",
                                "path": path, "reqs": breqs,
                                "refs": [bsv.forward(x) for x in breqs]}
            del bsv
        del bparams

        ranks = _Ranks(4, tmp)
        try:
            coll = ranks.run({"name": "collectives", "kind": "collectives"})
            print(f"[lm_tp] ms per gloo collective over 4 ranks sharing "
                  f"the card (rank 0): "
                  f"{ {k: round(v, 3) for k, v in coll[0].items()} }")
            for part, shape, backend, layouts in LM_TP_PARTITIONS:
                sv = whole[part]
                res = ranks.run({"name": part, "kind": "lm",
                                 "servable": (sv.params, sv.cfg, sv.spec,
                                              sv.packs, sv.export_stats),
                                 "layouts": layouts, "prompts": prompts,
                                 "logit_prompts": logit_prompts,
                                 "logit_tokens": ref_tokens[part],
                                 "n_new": LM_TP_NEW_TOKENS,
                                 "warm_up": False})
                _lm_tp_report(part, shape, layouts, res, refs, ref_logits,
                              whole[part], prompts, k1_per_pass, n_layers,
                              n_global, n_local, counts)
            res = ranks.run(bert_jobs[(1, 4)])
            _bert_tp_report((1, 4), res)
        finally:
            ranks.close()
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        ranks = _Ranks(2, tmp)
        try:
            _bert_tp_report((1, 2), ranks.run(bert_jobs[(1, 2)]))
            probe = ranks.run({"name": "probe", "kind": "probe"}, timeout=200)
            print(f"[lm_tp] gloo on CUDA tensors (2 ranks): {probe[0]}")
        finally:
            ranks.close()

    per = {}
    _decode_family_shapes(np.random.RandomState(seed), dev, per,
                          labels=("gemma3_tp4_g2_d256",
                                  "gemma3_tp4_ring_g2_d256"))
    for k, r in per.items():
        print(f"[lm_tp] K2/K3 at a rank's shape {k}: {r['ms']:.4f} ms "
              f"(cold {r['ms_cold']:.4f}), SDPA {r['library_ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return counts


def _lm_tp_report(part, shape, layouts, res, refs, ref_logits, ref_sv,
                  prompts, k1_per_pass, n_layers, n_global, n_local,
                  counts):
    """The checks and readings of one gemma3_4b partition."""
    import numpy as np
    import torch
    d, m = shape
    st = res[0]["sharding"]
    print(f"[lm_tp] {part} {shape}: {st['sharded_packs']} sharded / "
          f"{st['replicated_packs']} replicated packs, pack bytes per rank "
          f"{st['pack_bytes_per_device']} of {st['pack_bytes_total']}; "
          f"placement {max(r['place_s'] for r in res):.1f} s")
    if st["replicated_packs"] == 0:
        check(st["pack_bytes_per_device"] * m <= st["pack_bytes_total"],
              f"{part}: a rank holds more than 1/{m} of the pack bytes")
    for layout in layouts:
        ref = refs[(part, layout)]
        for r in res:
            run = r["runs"][layout]
            check(run["layout"] == layout, f"{part}: engine fell back from "
                  f"{layout}")
            check(all(s == "done" for s in run["status"]),
                  f"{part} {layout} rank {r['coord']}: {run['status']}")
            check(all(len(t) == LM_TP_NEW_TOKENS for t in run["tokens"]),
                  f"{part} {layout}: a request is short of tokens")
            steps, pre = run["steps"], run["prefills"]
            kernel = part == "dp"
            want = {"plan_dds": k1_per_pass * (steps + pre) if kernel else 0,
                    "flash_decode": steps * (n_layers if layout == "dense"
                                             else n_local),
                    "paged_flash_decode": steps * (0 if layout == "dense"
                                                   else n_global)}
            check(run["launches"] == want, f"{part} {layout} rank "
                  f"{r['coord']}: launches {run['launches']} differ from "
                  f"the layer routing {want}")
            check(run["cache_follows_spec"] and run["cache_kept_shapes"],
                  f"{part} {layout} rank {r['coord']}: a cache leaf does "
                  f"not follow spec_for_cache or changed shape")
            check(run["tokens"] == res[0]["runs"][layout]["tokens"],
                  f"{part} {layout}: the ranks' tokens differ")
            for k in LM_TP_KERNELS:
                counts[k] += run["launches"][k]
        run = res[0]["runs"][layout]
        got = run["tokens"]
        agree = sum(a == b for x, y in zip(ref, got) for a, b in zip(x, y))
        coll = run["collectives"]
        calls = sum(v["calls"] for v in coll.values())
        nbytes = sum(v["bytes"] for v in coll.values())
        secs = sum(v["s"] for v in coll.values())
        print(f"[lm_tp] {part} {layout}: {len(got)} requests done on every "
              f"rank, {run['steps']} decode steps in {run['windows']} "
              f"windows, {run['prefills']} prefills; launches per rank "
              f"{run['launches']} (= the routing); greedy tokens equal to "
              f"the single-device run: {agree} of "
              f"{sum(len(x) for x in ref)}; local KV leaf "
              f"{run['k_leaf'][0]} {run['k_leaf'][1]}")
        print(f"[lm_tp] {part} {layout}: host clock (ranks share the card: "
              f"no tensor-parallel speed) {1e3 * run['decode_s'] / run['steps']:.2f}"
              f" ms per decode step, prefill {run['prefill_s']:.2f} s, wall "
              f"{run['wall_s']:.2f} s; collectives in the run {calls} "
              f"({nbytes / 2**20:.1f} MiB, {secs:.2f} s of the host clock) "
              f"{coll}")
        logits = torch.from_numpy(res[0]["decode_logits"]).to(
            ref_logits[part].device)
        gap = float((logits - ref_logits[part]).abs().max())
        _near_tie_check(f"[lm_tp] {part} {layout}", ref_sv, prompts, ref,
                        _first_differences(ref, got), gap)
    logits = torch.from_numpy(res[0]["decode_logits"]).to(
        ref_logits[part].device)
    gap = float((logits - ref_logits[part]).abs().max())
    scale = float(ref_logits[part].abs().max())
    sc = res[0]["step_collectives"]
    print(f"[lm_tp] {part}: decode_step logits on 4 prefilled slots vs one "
          f"device max|d| {gap:.4e}, max|logits| {scale:.4e} (tol "
          f"{TOL_FLASH_VS_XLA * scale:.4e}); one decode step "
          f"{res[0]['decode_step_ms']:.2f} ms host clock, "
          f"{sum(v['calls'] for v in sc.values())} collectives, "
          f"{sum(v['bytes'] for v in sc.values())} bytes; peak memory per "
          f"rank {[round(r['peak_gib'], 2) for r in res]} GiB")
    check(len({r["decode_sum"] for r in res}) == 1,
          f"{part}: the ranks' decode logits differ")
    check(bool(np.isfinite(res[0]["decode_logits"]).all()),
          f"{part}: non-finite decode logits")
    check(gap <= TOL_FLASH_VS_XLA * scale,
          f"{part}: mesh decode logits disagree with one device")


def _bert_tp_report(shape, res):
    st = res[0]["sharding"]
    worst = max(max(r["errs"]) for r in res)
    print(f"[lm_tp] bert {shape}: {st['sharded_packs']} sharded / "
          f"{st['replicated_packs']} replicated packs, pack bytes per rank "
          f"{st['pack_bytes_per_device']} of {st['pack_bytes_total']}, "
          f"load {max(r['load_s'] for r in res):.1f} s; logits vs one "
          f"device max|d| {worst:.3e} (tol {TOL_LOGITS}); ms per (1, 384) "
          f"request {[round(x, 2) for x in res[0]['ms'][:-1]]}, (8, 384) "
          f"{res[0]['ms'][-1]:.2f} (host clock, shared card); peak memory "
          f"per rank {[round(r['peak_gib'], 2) for r in res]} GiB")
    check(all(r["finite"] for r in res), f"bert {shape}: non-finite logits")
    check(worst <= TOL_LOGITS, f"bert {shape}: mesh logits disagree")
    check(all(r["sums"] == res[0]["sums"] for r in res),
          f"bert {shape}: the ranks' logits differ")


# --------------------------------------------------------------------------
# phase 4g: lm_tp_families -- the vlm, MoE and MLA families on a mesh
# --------------------------------------------------------------------------

#: (model, depth cut or None, why, [(partition, mesh shape, backend, KV
#: layouts)]), one after the other
LM_TP_FAMILIES = (
    ("pixtral_12b", None, "full width and depth",
     (("tp", (1, 4), "plan", ("dense",)),)),
    ("deepseek_v2_lite_16b", 9,
     "full width, 9 of 27 layers: the dense first layer and 8 MoE layers, "
     "as lm_families (cut to fit lm_tp_train in the run's time limit)",
     (("tp", (1, 4), "plan", ("dense", "paged")),
      ("dp", (4, 1), "plan_pallas", ("dense",)),
      ("tp+dp", (2, 2), "plan", ("dense",)))),
    ("qwen3_moe_235b_a22b", 4,
     "full width, 4 of 94 layers (as lm_families: the whole model, ~470 "
     "GB bf16, does not fit the card's 80 GB)",
     (("tp", (1, 4), "plan", ("dense", "paged")),)))
#: the traffic of every family's mesh runs (gloo costs 3-7 ms a
#: collective): 2 requests into 4 slots, 4 new tokens each, no warm-up
#: (cut from 3 x 8 to fit lm_tp_recurrent in the run's time limit)
LM_TP_FAMILY_PROMPTS = (37, 150)
LM_TP_FAMILY_NEW = 4
#: the vlm forward on the mesh: (1, 300) tokens, 256 patch embeddings
LM_TP_VLM_TOKENS = 300


def phase_lm_tp_families(seed: int, card: str):
    """pixtral_12b (vlm, 40 layers), deepseek_v2_lite_16b (MLA + MoE, 9 of
    27 layers, as lm_families) and qwen3_moe_235b_a22b (MoE, full width, 4
    of 94 layers) over
    meshes of four processes sharing the card (gloo): each pruned once,
    exported per partition with ``place=False`` and handed to the ranks
    (CUDA IPC; ``place_servable`` keeps views of its shards), against the
    same export served on one device: pixtral tp (1, 4) with its vlm forward;
    qwen3_moe tp (1, 4) dense and paged (K2 / K3 on a rank's KV head);
    deepseek tp (1, 4) dense and paged latents, dp (4, 1) through K1 and
    tp+dp (2, 2). Checks: every request done; launches a rank = the
    routing; tokens = one device's except at near-ties; decode_step logits
    within 5% of max|logits|; cache, expert and latent shards; a rank's
    expert bytes; MoE routing flips only at near-ties."""
    import gc
    import torch
    dev = torch.device("cuda")
    base = dict(tile=(128, 128), sparsity=0.8, fuse_qkv=True,
                decode_kernel="flash")
    print(f"[lm_tp_families] {card}; 4 ranks share the card through gloo, "
          f"so their step times say nothing of tensor-parallel speed; "
          f"traffic a family: {len(LM_TP_FAMILY_PROMPTS)} requests of "
          f"{LM_TP_FAMILY_PROMPTS} prompt tokens x {LM_TP_FAMILY_NEW} new "
          f"tokens into 4 slots")
    counts = {k: 0 for k in LM_TP_KERNELS}
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _Ranks(4, tmp)
        try:
            for name, depth, why, parts in LM_TP_FAMILIES:
                t_model = time.perf_counter()
                summary[name] = _lm_tp_family(name, depth, why, parts, seed,
                                              dev, ranks, counts, base)
                gc.collect()
                torch.cuda.empty_cache()
                summary[name]["seconds"] = time.perf_counter() - t_model
                print(f"[lm_tp_families] {name}: "
                      f"{summary[name]['seconds']:.1f} s; device memory "
                      f"after freeing "
                      f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        finally:
            ranks.close()
    print(f"[lm_tp_families] summary {json.dumps(summary)}")
    return counts


def _lm_tp_family(name, depth, why, parts, seed, dev, ranks, counts, base):
    """One family over its partitions: exports, single-device references,
    the ranks' runs and their checks. Returns the family's readings."""
    import gc
    import numpy as np
    import torch
    from repro_torch.core.pruner import tied_prune
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.launch.sharding import leaf_name
    from repro_torch.models.api import init_model
    from repro_torch.serving import ServingSpec, prepare_servable
    from repro_torch.serving.servable import _routed_expert
    cfg = _family_config(name, depth)
    kinds = list(cfg.layer_plan()[0]) + list(cfg.layer_plan()[1]) * \
        cfg.layer_plan()[2] + list(cfg.layer_plan()[3])
    n_attn = sum(1 for k in kinds if k.mixer == "attn")
    n_moe = sum(1 for k in kinds if k.ffn == "moe")
    t0 = time.perf_counter()
    params = init_model(seed, cfg, device=dev)
    pruned, _ = tied_prune(params, ServingSpec(**base).sparsity_config())
    del params
    whole = {part: prepare_servable(
        pruned, cfg, ServingSpec(**base, prune="none", backend=backend,
                                 mesh_shape=shape, partition=part),
        device=dev, place=False) for part, shape, backend, _ in parts}
    del pruned
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    one = next(iter(whole.values()))
    k1_per_pass = sum(cfg.layer_plan()[2] if k.startswith("blocks/") else 1
                      for k in one.packs)
    expert_total = sum(
        x.numel() * x.element_size() for p, x in flatten_with_path(one.params)
        if _routed_expert(leaf_name(p), x.dim()))
    print(f"[lm_tp_families] {name} ({cfg.family}): {len(kinds)} layers "
          f"({why}); {n_attn} GQA attention ({cfg.n_kv_heads} KV heads), "
          f"{len(kinds) - n_attn} MLA (latent rank {cfg.kv_lora_rank}), "
          f"{n_moe} MoE FFN ({cfg.n_experts} experts); init + prune + "
          f"{len(whole)} sharded exports (place=False) "
          f"{time.perf_counter() - t0:.1f} s; routed-expert bytes "
          f"{expert_total}; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.RandomState(seed + 11)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in LM_TP_FAMILY_PROMPTS]
    # the decode_step logits' four slots: short prefills of the prompts
    logit_prompts = [prompts[0], prompts[1][:64], prompts[1][:100],
                     prompts[0][:20]]
    vlm = None
    if cfg.family == "vlm":
        toks = torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (1, LM_TP_VLM_TOKENS)).astype(np.int32)).to(
                dev)
        mm = torch.from_numpy((0.02 * rng.randn(
            1, cfg.n_patches, cfg.d_model)).astype(np.float32)).to(
                dev, cfg.tdtype)
        vlm = (toks, mm)
    rec = {"layers": len(kinds), "expert_bytes": expert_total,
           "partitions": {}}
    for part, shape, backend, layouts in parts:
        sv = whole[part]
        # the single-device runs: the same export on this one process
        t0 = time.perf_counter()
        refs = {}
        for layout in layouts:
            eng = sv.engine(max_slots=4, cache_len=1280, sync_every=8,
                            kv_layout=layout)
            hs = [eng.submit(p, max_new_tokens=LM_TP_FAMILY_NEW)
                  for p in prompts]
            eng.run()
            check(all(h.status == "done" for h in hs),
                  f"{name} {part} {layout}: a single-device request failed")
            refs[layout] = [list(h.tokens) for h in hs]
            del eng
        with _RouterLog() as ref_log:
            ref_logits, _, ref_tokens = _tp_decode_logits(sv, logit_prompts)
        job = {"name": f"{name} {part}", "kind": "lm",
               "phase": "lm_tp_families",
               "servable": (sv.params, sv.cfg, sv.spec, sv.packs,
                            sv.export_stats),
               "layouts": layouts, "prompts": prompts,
               "logit_prompts": logit_prompts, "logit_tokens": ref_tokens,
               "n_new": LM_TP_FAMILY_NEW, "warm_up": False}
        if vlm is not None:
            with torch.inference_mode():
                ref_fwd = sv.forward({"tokens": vlm[0], "mm_embeds": vlm[1]})
            job["vlm"] = (vlm[0], vlm[1], ref_fwd)
        t_ref = time.perf_counter() - t0
        res = ranks.run(job)
        rec["partitions"][part] = _lm_tp_family_report(
            name, cfg, part, shape, layouts, res, refs, ref_logits, ref_log,
            sv, prompts, logit_prompts, k1_per_pass, n_attn, n_moe,
            expert_total, counts, t_ref)
        del job
    del whole, one, sv
    return rec


def _lm_tp_family_report(name, cfg, part, shape, layouts, res, refs,
                         ref_logits, ref_log, ref_sv, prompts, logit_prompts,
                         k1_per_pass, n_attn, n_moe, expert_total, counts,
                         t_ref):
    """The checks and readings of one family's partition."""
    import numpy as np
    import torch
    d, m = shape
    tag = f"[lm_tp_families] {name} {part} {shape}"
    r0 = res[0]
    st = r0["sharding"]
    sh = r0["shards"]
    print(f"{tag}: {st['sharded_packs']} sharded / {st['replicated_packs']} "
          f"replicated packs, pack bytes a rank {st['pack_bytes_per_device']}"
          f" of {st['pack_bytes_total']}; single-device runs {t_ref:.1f} s; "
          f"placement {max(r['place_s'] for r in res):.1f} s")
    # expert and latent shards: E/m experts and r/m latent columns a rank
    for r in res:
        for leaf, (lshape, _) in r["shards"]["experts"].items():
            want_e = cfg.n_experts // m if cfg.n_experts % m == 0 \
                else cfg.n_experts
            check(lshape[-3] == want_e, f"{tag} rank {r['coord']}: {leaf} "
                  f"holds {lshape[-3]} experts, want {want_e}")
        for leaf, lshape in (r["shards"]["latent"] or {}).items():
            check(lshape[-1] == cfg.kv_lora_rank // m, f"{tag} rank "
                  f"{r['coord']}: {leaf} {lshape}, want r/{m}")
    rank_expert = max(sum(b for _, b in r["shards"]["experts"].values())
                      for r in res)
    if n_moe:
        print(f"{tag}: routed-expert bytes a rank {rank_expert} of "
              f"{expert_total} ({rank_expert / expert_total:.4f}); leaves "
              f"{ {k: v[0] for k, v in sh['experts'].items()} }; latent "
              f"cache {sh['latent']}")
        if m == 4:
            check(4 * rank_expert <= expert_total,
                  f"{tag}: a rank holds more than 1/4 of the expert bytes")
    elif sh["latent"]:
        print(f"{tag}: latent cache {sh['latent']}")
    out = {"runs": {}}
    for layout in layouts:
        ref = refs[layout]
        for r in res:
            run = r["runs"][layout]
            check(run["layout"] == layout, f"{tag}: fell back from {layout}")
            check(all(s == "done" for s in run["status"]),
                  f"{tag} {layout} rank {r['coord']}: {run['status']}")
            check(all(len(t) == LM_TP_FAMILY_NEW for t in run["tokens"]),
                  f"{tag} {layout}: a request is short of tokens")
            steps, pre = run["steps"], run["prefills"]
            want = {"plan_dds": k1_per_pass * (steps + pre)
                    if part == "dp" else 0,
                    "flash_decode": steps * n_attn if layout == "dense"
                    else 0,
                    "paged_flash_decode": steps * n_attn
                    if layout == "paged" else 0}
            check(run["launches"] == want, f"{tag} {layout} rank "
                  f"{r['coord']}: launches {run['launches']} differ from the "
                  f"layer routing {want}")
            check(run["cache_follows_spec"] and run["cache_kept_shapes"],
                  f"{tag} {layout} rank {r['coord']}: a cache leaf does not "
                  f"follow spec_for_cache or changed shape")
            check(run["tokens"] == r0["runs"][layout]["tokens"],
                  f"{tag} {layout}: the ranks' tokens differ")
            for k in LM_TP_KERNELS:
                counts[k] += run["launches"][k]
        run = r0["runs"][layout]
        got = run["tokens"]
        agree = sum(a == b for x, y in zip(ref, got) for a, b in zip(x, y))
        coll = run["collectives"]
        calls = sum(v["calls"] for v in coll.values())
        ms = 1e3 * run["decode_s"] / run["steps"]
        print(f"{tag} {layout}: {len(got)} requests done on every rank, "
              f"{run['steps']} decode steps in {run['windows']} windows, "
              f"{run['prefills']} prefills; launches a rank "
              f"{run['launches']} (= the routing); greedy tokens equal to "
              f"one device's: {agree} of {sum(len(x) for x in ref)}; local "
              f"cache leaf {run['k_leaf'][0]} {run['k_leaf'][1]}")
        print(f"{tag} {layout}: host clock (ranks share the card: no "
              f"tensor-parallel speed) {ms:.2f} ms a decode step, prefill "
              f"{run['prefill_s']:.2f} s, wall {run['wall_s']:.2f} s; "
              f"collectives in the run {calls} "
              f"({sum(v['bytes'] for v in coll.values()) / 2**20:.1f} MiB, "
              f"{sum(v['s'] for v in coll.values()):.2f} s of the host "
              f"clock) { {k: v['calls'] for k, v in coll.items()} }")
        out["runs"][layout] = {"agree": agree, "ms_per_step": ms,
                               "steps": run["steps"], "collectives": calls,
                               "launches": run["launches"]}
        if not n_moe:
            logits = torch.from_numpy(r0["decode_logits"]).to(
                ref_logits.device)
            gap = float((logits - ref_logits).abs().max())
            _near_tie_check(f"{tag} {layout}", ref_sv, prompts, ref,
                            _first_differences(ref, got), gap)
    logits = torch.from_numpy(r0["decode_logits"]).to(ref_logits.device)
    gap = float((logits - ref_logits).abs().max())
    scale = float(ref_logits.abs().max())
    tol = TOL_FLASH_VS_XLA * scale
    sc = r0["step_collectives"]
    n_sc = sum(v["calls"] for v in sc.values())
    print(f"{tag}: decode_step logits on 4 prefilled slots vs one device "
          f"max|d| {gap:.4e}, max|logits| {scale:.4e} (tol {tol:.4e}); one "
          f"decode step {r0['decode_step_ms']:.2f} ms host clock, {n_sc} "
          f"collectives ({sum(v['bytes'] for v in sc.values())} bytes; "
          f"{ {k: v['calls'] for k, v in sc.items()} }); peak memory a rank "
          f"{[round(r['peak_gib'], 2) for r in res]} GiB (the rank's own "
          f"allocations; its shards are views of the parent's export)")
    check(len({r["decode_sum"] for r in res}) == 1,
          f"{tag}: the ranks' decode logits differ")
    check(bool(np.isfinite(r0["decode_logits"]).all()),
          f"{tag}: non-finite decode logits")
    out.update(gap=gap, scale=scale, step_collectives=n_sc,
               peak_gib=[r["peak_gib"] for r in res])
    held = gap <= tol
    if n_moe:
        margins = _routing_flips(tag, r0["routing"], ref_log, cfg.top_k,
                                 what="the mesh's own routing vs one "
                                      "device's, decode_step and its "
                                      "prefills")
        print(f"{tag}: router flips' margins "
              f"{sorted(round(x, 5) for x in margins)}")
        out["router_flips"] = len(margins)
        # a flip at a router near-tie moves whole expert outputs (and at
        # capacity 1 which tokens drop): hold the arithmetic and the
        # tokens against one device routed as the mesh's rank 0 was (the
        # mesh keeps its own routing)
        with _RouterLog(replay=r0["routing"]):
            replayed, _, _ = _tp_decode_logits(ref_sv, logit_prompts,
                                               tokens=r0["logit_tokens"])
        gap_r = float((logits - replayed).abs().max())
        print(f"{tag}: decode_step logits vs one device routed as the "
              f"mesh: max|d| {gap_r:.4e} (tol {tol:.4e})")
        out["gap_same_routing"] = gap_r
        held = held or (bool(margins) and gap_r <= tol)
        for layout in layouts:
            out["runs"][layout]["agree_same_routing"] = _replayed_tokens(
                f"{tag} {layout}", ref_sv, prompts, layout,
                r0["runs"][layout], gap_r)
    if "vlm" in r0:
        worst = max(r["vlm"]["err"] for r in res)
        vs = r0["vlm"]["scale"]
        print(f"{tag}: forward (1, {LM_TP_VLM_TOKENS}) with "
              f"{cfg.n_patches} patch embeddings handed to every rank vs one "
              f"device: max|d| {worst:.4e}, max|logits| {vs:.4e} (tol "
              f"{TOL_FLASH_VS_XLA * vs:.4e})")
        check(all(r["vlm"]["finite"] for r in res), f"{tag}: vlm non-finite")
        check(worst <= TOL_FLASH_VS_XLA * vs,
              f"{tag}: the mesh's vlm forward disagrees with one device")
        out["vlm"] = {"max_abs_err": worst, "max_logits": vs}
    check(held, f"{tag}: mesh decode logits disagree with one device")
    return out


def _replayed_tokens(label, ref_sv, prompts, layout, run, gap):
    """A MoE run's tokens against one device replaying the mesh's routing
    of the counted run call for call (rank 0's log): a token that differs
    passes only where the replayed device's top-2 logit margin there is
    below twice the decode logits' max |difference| under the same routing
    (a near-tie). Returns the tokens equal."""
    import numpy as np
    eng = ref_sv.engine(max_slots=4, cache_len=1280, collect_logits=True,
                        kv_layout=layout)
    with _RouterLog(replay=run["routing"]) as log:
        hs = [eng.submit(p, max_new_tokens=LM_TP_FAMILY_NEW)
              for p in prompts]
        eng.run()
    check(len(log.calls) == len(run["routing"].calls),
          f"{label}: the replay made {len(log.calls)} routing calls, the "
          f"mesh {len(run['routing'].calls)}")
    ref = [list(h.tokens) for h in hs]
    got = run["tokens"]
    agree = sum(a == b for x, y in zip(ref, got) for a, b in zip(x, y))
    print(f"{label}: greedy tokens equal to one device routed as the mesh: "
          f"{agree} of {sum(len(x) for x in ref)}")
    for r, i in _first_differences(ref, got):
        top2 = np.sort(hs[r].step_logits[i])[-2:]
        margin = float(top2[1] - top2[0])
        print(f"{label}: request {r} first differs from the replay at token "
              f"{i}: top-2 margin {margin:.4e}, decode logits max|d| under "
              f"the same routing {gap:.4e}")
        check(margin < 2 * gap, f"{label}: request {r} token {i} differs "
              f"from one device routed as the mesh where the top-2 margin "
              f"{margin:.4e} is >= 2 x {gap:.4e}")
    del eng
    return agree


# --------------------------------------------------------------------------
# phase 4h: lm_tp_recurrent -- the ssm, hybrid and audio families on a mesh
# --------------------------------------------------------------------------

#: (model, dtype, [(partition, mesh shape, backend)]), one after the other,
#: every one at full width and depth
LM_TP_RECURRENT = (
    ("mamba2_780m", "bfloat16", (("tp", (1, 4), "plan"),
                                 ("tp+dp", (2, 2), "plan"))),
    ("mamba2_780m", "float32", (("tp", (1, 4), "plan"),)),
    ("recurrentgemma_9b", "bfloat16", (("tp", (1, 4), "plan"),
                                       ("dp", (4, 1), "plan_pallas"))),
    ("whisper_base", "bfloat16", (("tp", (1, 4), "dense"),
                                  ("tp+dp", (2, 2), "dense"))))
#: the recurrent LMs' traffic: 2 requests into 4 slots, 4 new tokens each
#: (cut from 3 x 8 to fit lm_tp_train in the run's time limit, as lm_tp's)
LM_TP_RECURRENT_PROMPTS = (37, 300)
LM_TP_RECURRENT_NEW = 4
#: whisper's: 2 requests of the start-of-transcript prompt's first 1 and 4
#: tokens, each with 1500 seeded frames, 4 new tokens, cache 448
AUDIO_TP_PROMPTS = (AUDIO_PROMPT[:1], AUDIO_PROMPT)
#: the fp32 mamba2 copy against one device's fp32 logits: PERF.md's bar of
#: mamba2's fp32 prefill check. It tells a wrong partition from bf16
#: rounding, which 48 random bf16 layers carry to ~4.5% of max|logits|
TOL_TP_FP32 = 1e-3


def phase_lm_tp_recurrent(seed: int, card: str):
    """mamba2_780m (ssm, 48 layers; bf16 over tp (1, 4) and tp+dp (2, 2),
    and an fp32 copy over tp), recurrentgemma_9b (hybrid, 38 layers: RG-LRU
    and MQA local attention; tp (1, 4) 'plan', dp (4, 1) through kernel K1)
    and whisper_base (audio, 6 + 6 layers, 1500 frames; tp and tp+dp,
    dense) at full width and depth over meshes of four processes sharing
    the card (gloo): each pruned once (whisper served unpruned, as the
    reference serves it), exported per partition with ``place=False`` and
    handed to the ranks (CUDA IPC; ``place_servable`` keeps views), against
    the same export served on one device. Checks: every request done on
    every rank; K1 / K2 launches a rank = the routing; tokens = one
    device's except at printed near-ties; decode_step logits within 5% of
    max|logits| (the fp32 mamba2 copy: 1e-3); every cache leaf
    ``spec_for_cache``'s shard (SSD ``state`` H/m, ``conv`` C/m, RG-LRU
    ``h`` W/m, cross K/V Hkv/m); collectives a decode step, their bytes,
    peak memory a rank printed; K2 at a whisper tp rank's decoder
    shape."""
    import gc
    import numpy as np
    import torch
    dev = torch.device("cuda")
    base = dict(tile=(128, 128), sparsity=0.8, fuse_qkv=True,
                decode_kernel="flash")
    print(f"[lm_tp_recurrent] {card}; 4 ranks share the card through gloo, "
          f"so their step times say nothing of tensor-parallel speed; "
          f"traffic: {len(LM_TP_RECURRENT_PROMPTS)} requests of "
          f"{LM_TP_RECURRENT_PROMPTS} prompt tokens (whisper: "
          f"{[len(p) for p in AUDIO_TP_PROMPTS]}) x {LM_TP_RECURRENT_NEW} "
          f"new tokens into 4 slots")
    counts = {k: 0 for k in LM_TP_KERNELS}
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _Ranks(4, tmp)
        try:
            for name, dtype, parts in LM_TP_RECURRENT:
                t_model = time.perf_counter()
                key = name if dtype == "bfloat16" else f"{name} {dtype}"
                summary[key] = _lm_tp_recurrent(name, dtype, parts, seed,
                                                dev, ranks, counts, base)
                gc.collect()
                torch.cuda.empty_cache()
                summary[key]["seconds"] = time.perf_counter() - t_model
                print(f"[lm_tp_recurrent] {key}: "
                      f"{summary[key]['seconds']:.1f} s; device memory "
                      f"after freeing "
                      f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        finally:
            ranks.close()
    per = {}
    _decode_family_shapes(np.random.RandomState(seed), dev, per,
                          labels=("whisper_tp4_g1_d64",))
    for k, r in per.items():
        print(f"[lm_tp_recurrent] K2 at a whisper tp (1, 4) rank's decoder "
              f"shape {k}: {r['ms']:.4f} ms (cold {r['ms_cold']:.4f}), SDPA "
              f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        summary[k] = r
    print(f"[lm_tp_recurrent] summary {json.dumps(summary)}")
    return counts


def _lm_tp_recurrent(name, dtype, parts, seed, dev, ranks, counts, base):
    """One model over its partitions: exports, single-device references,
    the ranks' runs and their checks. Returns the model's readings."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.core.pruner import tied_prune
    from repro_torch.models.api import init_model
    from repro_torch.serving import ServingSpec, prepare_servable
    cfg = _recurrent_config(name)
    if cfg.dtype != dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    depth = _recurrent_depth(name, cfg)
    audio = cfg.family == "audio"
    prefix, pattern, n_per, suffix = cfg.layer_plan()
    kinds = list(prefix) + list(pattern) * n_per + list(suffix)
    n_attn = cfg.n_layers if audio else sum(
        1 for k in kinds if k.mixer in ("attn", "local"))
    t0 = time.perf_counter()
    pruned = init_model(seed, cfg, device=dev)
    if not audio:
        pruned, _ = tied_prune(pruned, ServingSpec(**base).sparsity_config())
    whole = {part: prepare_servable(
        pruned, cfg, ServingSpec(**base, prune="none", backend=backend,
                                 mesh_shape=shape, partition=part),
        device=dev, place=False) for part, shape, backend in parts}
    del pruned
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    k1_per_pass = {part: sum(n_per if k.startswith("blocks/") else 1
                             for k in sv.packs)
                   for part, sv in whole.items()}
    mixers = {m: sum(1 for k in kinds if k.mixer == m)
              for m in sorted({k.mixer for k in kinds})}
    enc = f"{cfg.n_enc_layers} encoder + " if audio else ""
    print(f"[lm_tp_recurrent] {name} ({cfg.family}, {cfg.dtype}): {enc}"
          f"{len(kinds)} layers {mixers}, {depth}; init"
          f"{'' if audio else ' + prune'} + {len(whole)} sharded exports "
          f"(place=False) {time.perf_counter() - t0:.1f} s; packs "
          f"{ {p: len(sv.packs) for p, sv in whole.items()} }; device "
          f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.RandomState(seed + 11)
    if audio:
        prompts = [list(p) for p in AUDIO_TP_PROMPTS]
        frames = [rng.randn(cfg.n_audio_ctx, cfg.d_model).astype(np.float32)
                  for _ in prompts]
        logit_prompts = prompts + [list(AUDIO_PROMPT[:3]),
                                   list(AUDIO_PROMPT[:2])]
        logit_frames = [torch.from_numpy(f).to(dev)
                        for f in frames + [frames[0], frames[1]]]
        cache_len = AUDIO_CACHE_LEN
    else:
        prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
                   for n in LM_TP_RECURRENT_PROMPTS]
        frames = logit_frames = None
        # the decode_step logits' four slots: short prefills of the prompts
        logit_prompts = [prompts[0], prompts[1][:64], prompts[1][:100],
                         prompts[0][:20]]
        cache_len = 1280
    extra = [{} if f is None else {"frames": f}
             for f in (frames or [None] * len(prompts))]
    rec = {"layers": len(kinds), "dtype": cfg.dtype, "partitions": {}}
    for part, shape, backend in parts:
        sv = whole[part]
        # the single-device run: the same export on this one process
        t0 = time.perf_counter()
        eng = sv.engine(max_slots=4, cache_len=cache_len, sync_every=8)
        hs = [eng.submit(p, max_new_tokens=LM_TP_RECURRENT_NEW, **x)
              for p, x in zip(prompts, extra)]
        eng.run()
        check(all(h.status == "done" for h in hs),
              f"{name} {part}: a single-device request failed")
        ref = [list(h.tokens) for h in hs]
        del eng, hs
        ref_logits, _, ref_tokens = _tp_decode_logits(
            sv, logit_prompts, cache_len, logit_frames)
        t_ref = time.perf_counter() - t0
        job = {"name": f"{name} {part}", "kind": "lm",
               "phase": "lm_tp_recurrent",
               "servable": (sv.params, sv.cfg, sv.spec, sv.packs,
                            sv.export_stats),
               "layouts": ("dense",), "prompts": prompts,
               "logit_prompts": logit_prompts, "n_new": LM_TP_RECURRENT_NEW,
               "cache_len": cache_len, "frames": frames,
               "logit_frames": logit_frames, "logit_tokens": ref_tokens,
               "warm_up": False}
        res = ranks.run(job)
        own = res[0]["prefill_tokens"]
        print(f"[lm_tp_recurrent] {name} ({cfg.dtype}) {part} {shape}: the "
              f"logits step feeds both sides one device's next tokens "
              f"{ref_tokens}; the mesh's own prefill rows' greedy tokens "
              f"{own} ({sum(a == b for a, b in zip(own, ref_tokens))} of 4 "
              f"equal)")
        rec["partitions"][part] = _lm_tp_recurrent_report(
            name, cfg, part, shape, res, ref, ref_logits, sv, prompts,
            frames, k1_per_pass[part], n_attn, counts, t_ref)
        del job, res
    del whole, sv
    return rec


def _local_model_dim(cfg, leaf):
    """(dim, whole size) of a recurrent or audio cache leaf's "model"
    candidate dim: SSD ``state`` heads, ``conv`` channels, RG-LRU ``h``
    width, the K/V heads; None for other leaves."""
    if leaf.endswith("mix/state"):
        return -3, cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    if leaf.endswith("mix/conv"):
        return -1, (cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state
                    if cfg.family == "ssm" else cfg.rnn_width or cfg.d_model)
    if leaf.endswith("mix/h"):
        return -1, cfg.rnn_width or cfg.d_model
    if leaf.endswith(("cross_k", "cross_v", "self/k", "mix/k")):
        return -2, cfg.n_kv_heads
    return None


def _lm_tp_recurrent_report(name, cfg, part, shape, res, ref, ref_logits,
                            ref_sv, prompts, frames, k1_per_pass, n_attn,
                            counts, t_ref):
    """The checks and readings of one model's partition."""
    import numpy as np
    import torch
    d, m = shape
    tag = f"[lm_tp_recurrent] {name} ({cfg.dtype}) {part} {shape}"
    r0 = res[0]
    st = r0["sharding"]
    print(f"{tag}: {st['sharded_packs']} sharded / {st['replicated_packs']} "
          f"replicated packs, pack bytes a rank {st['pack_bytes_per_device']}"
          f" of {st['pack_bytes_total']}; single-device run + logits "
          f"{t_ref:.1f} s; placement {max(r['place_s'] for r in res):.1f} s")
    for r in res:
        run = r["runs"]["dense"]
        where = f"{tag} rank {r['coord']}"
        check(run["layout"] == "dense", f"{where}: layout {run['layout']}")
        check(all(s == "done" for s in run["status"]),
              f"{where}: {run['status']}")
        check(all(len(t) == LM_TP_RECURRENT_NEW for t in run["tokens"]),
              f"{where}: a request is short of tokens")
        steps, pre = run["steps"], run["prefills"]
        if cfg.family == "audio":
            # every prompt prefills through the decode path, padding steps
            # included, replicated on every rank
            pre_steps = sum(b * n for b, n in run["buckets"].items())
            want = {"plan_dds": 0, "flash_decode": n_attn * (steps
                                                              + pre_steps),
                    "paged_flash_decode": 0}
        else:
            want = {"plan_dds": k1_per_pass * (steps + pre)
                    if part == "dp" else 0,
                    "flash_decode": n_attn * steps, "paged_flash_decode": 0}
        check(run["launches"] == want, f"{where}: launches "
              f"{run['launches']} differ from the layer routing {want}")
        check(run["cache_follows_spec"] and run["cache_kept_shapes"]
              and run["sub_follows_spec"], f"{where}: a cache leaf does not "
              f"follow spec_for_cache or changed shape")
        for leaf, lshape in run["leaves"].items():
            md = _local_model_dim(cfg, leaf)
            if md is None:
                continue
            dim, n = md
            want_n = n // m if n % m == 0 and n >= m else n
            check(lshape[dim] == want_n, f"{where}: {leaf} {lshape}, want "
                  f"{want_n} of {n} along dim {dim}")
        check(run["tokens"] == r0["runs"]["dense"]["tokens"],
              f"{tag}: the ranks' tokens differ")
        for k in LM_TP_KERNELS:
            counts[k] += run["launches"][k]
    run = r0["runs"]["dense"]
    got = run["tokens"]
    agree = sum(a == b for x, y in zip(ref, got) for a, b in zip(x, y))
    coll = run["collectives"]
    calls = sum(v["calls"] for v in coll.values())
    ms = 1e3 * run["decode_s"] / run["steps"]
    print(f"{tag}: {len(got)} requests done on every rank, {run['steps']} "
          f"decode steps in {run['windows']} windows, {run['prefills']} "
          f"prefills (buckets {run['buckets']}); launches a rank "
          f"{run['launches']} (= the routing); greedy tokens equal to one "
          f"device's: {agree} of {sum(len(x) for x in ref)}; local cache "
          f"leaves {run['leaves']}")
    print(f"{tag}: host clock (ranks share the card: no tensor-parallel "
          f"speed) {ms:.2f} ms a decode step, prefill {run['prefill_s']:.2f} "
          f"s, wall {run['wall_s']:.2f} s; collectives in the run {calls} "
          f"({sum(v['bytes'] for v in coll.values()) / 2**20:.1f} MiB, "
          f"{sum(v['s'] for v in coll.values()):.2f} s of the host clock) "
          f"{ {k: v['calls'] for k, v in coll.items()} }")
    logits = torch.from_numpy(r0["decode_logits"]).to(ref_logits.device)
    gap = float((logits - ref_logits).abs().max())
    scale = float(ref_logits.abs().max())
    by_slot = [round(float(g), 5)
               for g in (logits - ref_logits).abs().amax(-1)]
    bar = TOL_TP_FP32 if cfg.dtype == "float32" else TOL_FLASH_VS_XLA
    margins = _near_tie_check(tag, ref_sv, prompts, ref,
                              _first_differences(ref, got), gap, frames)
    sc = r0["step_collectives"]
    n_sc = sum(v["calls"] for v in sc.values())
    b_sc = sum(v["bytes"] for v in sc.values())
    print(f"{tag}: decode_step logits on 4 prefilled slots vs one device "
          f"max|d| {gap:.4e} (by slot {by_slot}), max|logits| {scale:.4e} "
          f"({gap / scale:.4%}; tol {bar * scale:.4e}); one decode step "
          f"{r0['decode_step_ms']:.2f} ms host clock, {n_sc} collectives "
          f"({b_sc} bytes; { {k: v['calls'] for k, v in sc.items()} }); "
          f"peak memory a rank {[round(r['peak_gib'], 2) for r in res]} GiB "
          f"(its own allocations; its shards are views of the parent's "
          f"export)")
    check(len({r["decode_sum"] for r in res}) == 1,
          f"{tag}: the ranks' decode logits differ")
    check(bool(np.isfinite(r0["decode_logits"]).all()),
          f"{tag}: non-finite decode logits")
    check(gap <= bar * scale, f"{tag}: mesh decode logits disagree with one "
          f"device ({gap / scale:.4%} of max|logits|, bar {bar:.2%})")
    return {"agree": agree, "tokens": sum(len(x) for x in ref),
            "near_tie_margins": margins, "gap": gap, "scale": scale,
            "gap_by_slot": by_slot,
            "steps": run["steps"], "ms_per_step": ms,
            "launches": run["launches"], "collectives": calls,
            "step_collectives": n_sc, "step_collective_bytes": b_sc,
            "leaves": run["leaves"], "peak_gib": [r["peak_gib"] for r in res]}


# --------------------------------------------------------------------------
# phase 4i: lm_tp_train -- the Trainer on a mesh (ranks share the card)
# --------------------------------------------------------------------------

#: gemma3_4b's mesh training: full width, LMT_LAYERS layers, B 4 x S 512
#: (the 2,048 tokens of lm_training's Trainer step)
LMT_TP_BATCH, LMT_TP_SEQ = 4, 512
#: (partition, mesh shape, steps); the 6-step runs checkpoint every 4 steps
#: and take a fault at step 5
LMT_TP_PARTS = (("dp", (4, 1), 6), ("tp+dp", (2, 2), 6), ("tp", (1, 4), 2))
LMT_TP_FAULT = 5
LMT_TP_CKPT_EVERY = 4
#: the fp32 copies: dp and tp at 2 layers, 2 steps
LMT_TP_FP32_LAYERS, LMT_TP_FP32_STEPS = 2, 2
#: loss and grad_norm of a mesh step against one device's: bf16 (the
#: mesh's row blocks and fp32 sums round elsewhere than one device's
#: GEMMs) and fp32 (only the order of fp32 sums differs)
TOL_MESH_TRAIN = {"bfloat16": 1e-3, "float32": 1e-5}
#: BERT-base over (1, 4): 768 rows a weight, 192 a rank, 128-row tiles
BERT_TP_TRAIN_STEPS = 4
BERT_TP_BATCH, BERT_TP_SEQ = 8, 384
BERT_TP_PACKED_STEPS = 2


def _lmtt_cfg(layers, dtype):
    import dataclasses
    from repro_torch.core.sparsity import SparsityConfig
    sp = SparsityConfig(block_shape=(16, 16), sparsity=0.7, lambda_reg=1e-4,
                        start_step=2, end_step=6)
    return dataclasses.replace(_lm_config(), n_layers=layers, dtype=dtype,
                               sparsity=sp)


def _bert_train_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import SparsityConfig
    sp = SparsityConfig(block_shape=(128, 128), sparsity=0.8,
                        lambda_reg=1e-4, start_step=1, end_step=3)
    cfg = dataclasses.replace(get_config("bert_base"), sparsity=sp)
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size)
          == (12, 768, 3072, 30522), "not BERT-base at full width")
    return cfg


def _train_counters():
    from repro_torch.kernels import bsr_matmul as bm
    from repro_torch.kernels import plan_dds
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)
    return {"plan_dds": plan_dds, "flash_decode": flash_decode,
            "paged_flash_decode": paged_flash_decode, "dds": bm.dds,
            "dds_t": bm.dds_t, "plan_dds_t": bm.plan_dds_t,
            "sddmm": bm.sddmm, "plan_sddmm": bm.plan_sddmm}


def _lmtt_opt(cfg):
    """AdamW of the phase's runs: gemma3_4b bf16 keeps its moments in
    bf16 (the reference's option for optimizer memory at scale), so a
    checkpoint of the 6-layer state is 7.4 GB, not 12.4: four of them fit
    the run's time limit (the disk takes ~1.3 GB/s); fp32 models keep
    fp32 moments."""
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(state_dtype="bfloat16" if cfg.dtype == "bfloat16"
                       and cfg.family != "bert" else "float32")


def _lmtt_trainer(cfg, ckpt_dir, seed, n_steps, dev, mesh=None,
                  fault=None, batch=LMT_TP_BATCH, seq=LMT_TP_SEQ,
                  norms=False):
    """A Trainer (one device or ``mesh``) that records each step: host
    seconds, the metrics, the mesh's collectives (calls, bytes, host s;
    reset before the step), the masks and, with ``norms``, the pruned
    leaves' whole block norms the masks were scored on (their collectives
    left out of the step's)."""
    from repro_torch.core.pruner import whole_block_norms
    from repro_torch.core.tree import flatten_with_path, path_name
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.runtime.fault_tolerance import (FaultInjector,
                                                     FaultToleranceConfig)
    import torch
    tcfg = TrainConfig(n_steps=n_steps, ckpt_dir=ckpt_dir, seed=seed,
                       log_every=1, opt=_lmtt_opt(cfg), prune=True,
                       ft=FaultToleranceConfig(
                           checkpoint_every=LMT_TP_CKPT_EVERY))
    inj = FaultInjector(fail_at_steps=(fault,)) if fault is not None \
        else None
    tr = Trainer(cfg, tcfg, device=dev, data_cfg=DataConfig(
        seq_len=seq, global_batch=batch, vocab_size=cfg.vocab_size),
        fault_injector=inj, mesh=mesh)
    tr.rec = []
    one, step_fn = tr._one_step, tr.step_fn
    scored = {}

    def stepped(*args):
        params, opt, metrics = step_fn(*args)
        if not norms:
            return params, opt, metrics
        sp = cfg.sparsity
        saved = copy.deepcopy(mesh.stats) if mesh is not None else None
        shards = tr.shards(params) or {}
        todo = [(p, x) for p, x in flatten_with_path(params)
                if sp.applies_to(path_name(p)) and x.dim() in (2, 3)]
        grids = whole_block_norms([(x, shards.get(p)) for p, x in todo],
                                  sp.block_shape, sp.group_norm_ord)
        scored["norms"] = {path_name(p): g.cpu().numpy()
                           for (p, _), g in zip(todo, grids)}
        if mesh is not None:
            mesh.stats = saved
        return params, opt, metrics

    def recorded(state, step):
        if mesh is not None:
            mesh.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = one(state, step)
        torch.cuda.synchronize()
        r = {"step": step, "s": time.perf_counter() - t0, **metrics,
             "stats": copy.deepcopy(mesh.stats) if mesh is not None else {},
             "norms": scored.pop("norms", None),
             "masks": {path_name(p): m.cpu().numpy() for p, m in
                       flatten_with_path(state["masks"] or {})}}
        tr.rec.append(r)
        if mesh is not None and mesh.rank == 0:
            c, b, t = _step_stats(r)
            print(f"[lm_tp_train] rank 0 {tuple(mesh.shape.values())} step "
                  f"{step}: {r['s']:.3f} s, loss {r['loss']!r}, grad_norm "
                  f"{r['grad_norm']!r}, {c} collectives, "
                  f"{b / 1e9:.3f} GB, {t:.3f} s in them", flush=True)
        return state, metrics

    def timed(kind, fn):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            tr.io.append((kind, time.perf_counter() - t0))
            return out
        return run
    tr.io = []
    tr.step_fn, tr._one_step = stepped, recorded
    tr.save_state = timed("save", tr.save_state)
    tr.restore_state = timed("restore", tr.restore_state)
    tr.store.wait = timed("wait", tr.store.wait)
    tr.injector_ = inj
    return tr


def _lmtt_run(tr, n_steps):
    """The Trainer's own step ``n_steps`` times from its initial state, no
    Supervisor and no checkpoint (the references and the short runs)."""
    from repro_torch.data.pipeline import DataPipeline
    tr.pipeline = DataPipeline(tr.data_cfg)
    try:
        state = tr.init_state()
        for step in range(n_steps):
            state, _ = tr._one_step(state, step)
    finally:
        tr.pipeline.close()
    return state


def _state_bytes(state):
    from repro_torch.core.tree import leaves
    return {k: sum(x.numel() * x.element_size() for x in leaves(state[k]))
            for k in ("params", "opt")}


def _rank_train_job(job):
    """A rank's part of lm_tp_train: ``what`` 'lm' (a mesh Trainer run:
    ``fit`` with checkpoints and a fault, or the bare step loop), 'restore'
    (the (2, 2) checkpoint restored on other shapes, then steps), 'bert'
    (BERT-base pruned on a mesh) or 'packed' (the dp packed step through
    K1 / K4 / K5); or of lm_pipe_compress (``phase``): 'compress'
    (compressed DP), 'pipe' (GPipe forward and backward) or 'pipe_packed'
    (GPipe through K1). The mesh's axes are ``axes`` (("data", "model")
    by default)."""
    import gc
    import torch
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.launch.staging import install as install_staging
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    mesh = init_process_mesh(tuple(job["shape"]),
                             tuple(job.get("axes", ("data", "model"))))
    # the ranks share the card: collectives through CUDA IPC buffers, not
    # gloo's host round trip (~0.35 GB/s a 92 MB all_reduce, lm_tp's probe)
    install_staging(mesh, "cuda")
    say = _rank_say(mesh.rank, job["name"], job.get("phase", "lm_tp_train"))
    try:
        out = {"lm": _rank_train_lm, "restore": _rank_train_restore,
               "bert": _rank_train_bert, "packed": _rank_train_packed,
               "compress": _rank_pc_compress, "pipe": _rank_pipe,
               "pipe_packed": _rank_pipe_packed}[job["what"]](job, mesh,
                                                              dev, say)
    finally:
        gc.collect()
        torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["coord"] = mesh.coordinate
    return out


_RANK_JOBS["train"] = _rank_train_job


def _rank_train_lm(job, mesh, dev, say):
    import torch
    cfg = _lmtt_cfg(job["layers"], job["dtype"])
    tr = _lmtt_trainer(cfg, job["ckpt_dir"], job["seed"], job["steps"], dev,
                       mesh, job.get("fault"))
    for fn in _train_counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    if job.get("fit"):
        state, _ = tr.fit(resume=False)
        restarts = tr.supervisor.restarts
    else:
        state, restarts = _lmtt_run(tr, job["steps"]), 0
    wall = time.perf_counter() - t0
    say(f"{len(tr.rec)} steps run, {restarts} restarts, {wall:.1f} s")
    launches = {n: fn.launches for n, fn in _train_counters().items()}
    local = {n: tuple(x.shape) for n, x in _named_leaves(state["params"])}
    out = {"rec": [{k: v for k, v in r.items() if k != "masks"}
                   for r in tr.rec], "restarts": restarts, "wall": wall,
           "launches": launches, "bytes": _state_bytes(state),
           "local_shapes": local, "step": int(state["opt"]["step"]),
           "fired": sorted(tr.injector_.fired) if tr.injector_ else [],
           "io": tr.io,
           "masks_last": tr.rec[-1]["masks"] if mesh.rank == 0 else None}
    del state, tr
    torch.cuda.synchronize()
    return out


def _named_leaves(tree):
    from repro_torch.core.tree import flatten_with_path, path_name
    return [(path_name(p), x) for p, x in flatten_with_path(tree)]


def _ckpt_mismatches(state, path, step, specs, mesh=None):
    """Leaves of a restored state not bitwise equal to their part (a
    rank's ``local_shard``, or whole) of the checkpoint's arrays, read
    from the file itself."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.store import npz_mmap, spec_at
    from repro_torch.core.tree import flatten_with_path, path_name
    from repro_torch.launch.sharding import local_shard
    arrays = npz_mmap(os.path.join(path, f"step_{step:09d}", "arrays.npz"))
    coord = ({a: mesh.coord(a) for a in mesh.axis_names}
             if mesh is not None else {})
    bad, n = [], 0
    for i, (p, x) in enumerate(flatten_with_path(state)):
        n += 1
        arr = arrays[f"a{i}"]
        spec = spec_at(specs, p) if specs is not None else None
        if mesh is not None and spec:
            arr = local_shard(arr, spec, mesh, coord)
        # the raw bytes, compared on the card
        want = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(
            np.uint8)).to(x.device)
        got = x.detach().contiguous().reshape(-1).view(torch.uint8)
        if tuple(x.shape) != tuple(arr.shape) or not torch.equal(got, want):
            bad.append(path_name(p))
    return bad, n


def _rank_train_restore(job, mesh, dev, say):
    """The (2, 2) checkpoint restored on this mesh shape: every leaf
    bitwise its shard of the file; then ``steps`` more steps from it."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.data.pipeline import DataPipeline
    cfg = _lmtt_cfg(job["layers"], job["dtype"])
    tr = _lmtt_trainer(cfg, job["scratch_dir"], job["seed"], 1, dev, mesh)
    like = tr.init_state()
    t0 = time.perf_counter()
    state = tr.restore_state(CheckpointStore(job["ckpt_dir"]), job["step"],
                             like)
    restore_s = time.perf_counter() - t0
    del like
    bad, n = _ckpt_mismatches(state, job["ckpt_dir"], job["step"],
                              tr.specs(), mesh)
    say(f"restored step {job['step']} in {restore_s:.1f} s: {n - len(bad)} "
        f"of {n} leaves bitwise")
    tr.pipeline = DataPipeline(tr.data_cfg)
    try:
        for step in range(job["step"], job["step"] + job["steps"]):
            state, _ = tr._one_step(state, step)
    finally:
        tr.pipeline.close()
    out = {"bad": bad, "n": n, "restore_s": restore_s,
           "rec": [{k: v for k, v in r.items() if k != "masks"}
                   for r in tr.rec]}
    del state, tr
    return out


def _rank_train_bert(job, mesh, dev, say):
    cfg = _bert_train_cfg()
    tr = _lmtt_trainer(cfg, job["ckpt_dir"], job["seed"], job["steps"], dev,
                       mesh, batch=BERT_TP_BATCH, seq=BERT_TP_SEQ,
                       norms=True)
    state = _lmtt_run(tr, job["steps"])
    say(f"{len(tr.rec)} steps")
    out = {"rec": tr.rec, "bytes": _state_bytes(state)}
    del state, tr
    return out


def _rank_train_packed(job, mesh, dev, say):
    """The dp packed step: the whole packs and params the parent shares
    (CUDA IPC; the step is functional, so they are only read), this rank's
    rows, K1 / K4 / K5 launches counted a step."""
    import numpy as np
    import torch
    from repro_torch.launch.sharding import local_rows
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    cfg = _bert_train_cfg()
    params, packs = job.pop("params"), job.pop("packs")
    opt = AdamWConfig(peak_lr=1e-4, warmup_steps=2, total_steps=10,
                      weight_decay=0.01)
    step = make_train_step(cfg, opt, packs=packs, mesh=mesh)
    ost = init_opt_state(params, opt)
    counters = _train_counters()
    rec = []
    for i, batch in enumerate(job["batches"]):
        rows = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            dev, torch.int64) for k, v in local_rows(batch, mesh).items()}
        for fn in counters.values():
            fn.launches = 0
        mesh.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, ost, m = step(params, ost, rows)
        torch.cuda.synchronize()
        rec.append({"s": time.perf_counter() - t0,
                    "launches": {n: fn.launches
                                 for n, fn in counters.items()},
                    "stats": copy.deepcopy(mesh.stats),
                    "rows": int(rows["tokens"].shape[0]),
                    **{k: float(v) for k, v in m.items()}})
    say(f"{len(rec)} packed steps")
    del params, ost
    return {"rec": rec}


def _step_stats(rec):
    """(collectives, bytes, host s) of a recorded step."""
    st = rec["stats"]
    return (sum(v["calls"] for v in st.values()),
            sum(v["bytes"] for v in st.values()),
            sum(v["s"] for v in st.values()))


def _lmtt_compare(tag, res, ref, dtype, steps=None):
    """Every rank's per-step loss and grad_norm equal across the ranks and
    within TOL_MESH_TRAIN[dtype] relative of one device's, step by step
    (the last run of each step: a restart re-runs steps)."""
    import numpy as np
    tol = TOL_MESH_TRAIN[dtype]
    by_step = [{r["step"]: r for r in rank["rec"]} for rank in res]
    want = {r["step"]: r for r in ref}
    steps = sorted(by_step[0]) if steps is None else steps
    worst = {"loss": 0.0, "grad_norm": 0.0}
    rel_by_step, bad = [], []
    for s in steps:
        first = by_step[0][s]
        for r, rank in enumerate(by_step):
            for k in ("loss", "grad_norm"):
                if rank[s][k] != first[k]:
                    bad.append(f"step {s} {k} differs between rank 0 "
                               f"({first[k]!r}) and rank {r} "
                               f"({rank[s][k]!r})")
        rels = {}
        for k in worst:
            rel = abs(first[k] - want[s][k]) / abs(want[s][k])
            rels[k] = rel
            worst[k] = max(worst[k], rel)
            if not (np.isfinite(first[k]) and rel <= tol):
                bad.append(f"step {s} {k} {first[k]!r} against one "
                           f"device's {want[s][k]!r}: {rel:.3e} relative "
                           f"> {tol}")
        rel_by_step.append((s, rels["loss"], rels["grad_norm"]))
    print(f"{tag}: relative to one device by step (step, loss, grad_norm) "
          f"{[(s, float(f'{a:.3e}'), float(f'{b:.3e}')) for s, a, b in rel_by_step]}")
    check(not bad, f"{tag}: " + "; ".join(bad))
    return worst


def _print_rank_steps(tag, res):
    """Per rank: host clock a step, collectives a step (calls, MB, host
    s), peak memory, param and optimizer bytes."""
    for r, rank in enumerate(res):
        recs = rank["rec"]
        calls = [_step_stats(x) for x in recs]
        print(f"{tag} rank {r} {rank['coord']}: host s a step "
              f"{[round(x['s'], 3) for x in recs]}; collectives a step "
              f"{[c for c, _, _ in calls]}, MB "
              f"{[round(b / 1e6, 1) for _, b, _ in calls]}, host s in them "
              f"{[round(t, 3) for _, _, t in calls]}; peak "
              f"{rank['peak_gib']:.2f} GiB"
              + (f"; params {rank['bytes']['params'] / 1e9:.3f} GB, "
                 f"optimizer {rank['bytes']['opt'] / 1e9:.3f} GB"
                 if "bytes" in rank else ""))
    first = res[0]["rec"][-1]["stats"]
    print(f"{tag} rank 0's last step by collective: "
          f"{ {k: (v['calls'], round(v['bytes'] / 1e6, 1), round(v['s'], 3)) for k, v in first.items()} }")


def _mask_near_ties(tag, mesh_rec, one_rec, sp):
    """Every mesh step's masks against one device's: a differing block
    must be a near-tie -- its one-device block norm within twice the
    leaf's max |norm difference| (mesh vs one device) of its layer's
    quantile. Returns (blocks compared, differing, the margins)."""
    import numpy as np
    from repro_torch.core.pruner import cubic_sparsity
    one = {r["step"]: r for r in one_rec}
    n, diff, margins = 0, 0, []
    for r in mesh_rec:
        s, want = r["step"], one[r["step"]]
        target = cubic_sparsity(s, sp)
        for name, m in r["masks"].items():
            w = want["masks"][name]
            n += w.size
            bad = np.argwhere(m != w)
            if not len(bad):
                continue
            norms_one, norms_mesh = want["norms"][name], r["norms"][name]
            gap = float(np.abs(norms_mesh - norms_one).max())
            layers = norms_one if norms_one.ndim == 3 else norms_one[None]
            for idx in bad:
                li, bi, bj = idx if norms_one.ndim == 3 else (0, *idx)
                flat = layers[li].reshape(-1).astype(np.float64)
                q = float(np.quantile(flat, target))
                margin = abs(float(layers[li][bi, bj]) - q)
                diff += 1
                margins.append(margin)
                print(f"{tag} near-tie? step {s} {name} block {tuple(idx)}: "
                      f"|norm - quantile| {margin:.4e}, 2 x max|d norm| "
                      f"{2 * gap:.4e}")
                check(margin < 2 * gap, f"{tag}: step {s} {name} block "
                      f"{tuple(idx)} differs from one device's mask away "
                      f"from a near-tie ({margin:.4e} >= {2 * gap:.4e})")
    return n, diff, margins


def phase_lm_tp_train(seed: int, card: str):
    """The Trainer on a mesh: four processes sharing the card, as lm_tp,
    their collectives through CUDA IPC staging buffers (``launch/
    staging.py``; gloo, as lm_tp's, would take most of the run). a.
    gemma3_4b at full width, LMT_LAYERS layers, B 4 x S 512,
    pruning to 0.7 at 16x16 from step 2 to 6 with the prox, over dp (4, 1)
    and tp+dp (2, 2) for 6 steps (checkpoints every 4, a fault at step 5)
    and tp (1, 4) for 2, against one device's Trainer on the same seed
    and batches (bf16: 1e-3); an fp32 copy of dp and tp at 2 layers
    (1e-5). b. the (2, 2) step-4 checkpoint restored bitwise at (1, 4),
    (4, 1) and on one device; 2 more steps at (1, 4). c. BERT-base over
    (1, 4) pruned at 128x128 (tiles straddle the 192-row shards), masks
    against one device's; then 2 packed steps over dp (4, 1) through K1 /
    K4 / K5 (48 each a step a rank). Returns the packed steps' launches."""
    import gc
    import shutil
    import torch
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.serving import ServingSpec, prepare_servable
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lmtt_cfg(LMT_LAYERS, "bfloat16")
    print(f"[lm_tp_train] {card}; {cfg.arch} at full width, {cfg.n_layers} "
          f"layers, B {LMT_TP_BATCH} x S {LMT_TP_SEQ}; 4 ranks share the "
          f"card, their collectives through CUDA IPC staging buffers "
          f"(launch/staging.py), so their times say nothing of the mesh's "
          f"speed")
    rec = {}
    marks = [time.perf_counter()]

    def part(name):
        gc.collect()
        torch.cuda.empty_cache()
        marks.append(time.perf_counter())
        print(f"[lm_tp_train] {name}: {marks[-1] - marks[-2]:.1f} s")

    # one device's references, first, then freed
    refs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype, layers, steps in (("bfloat16", LMT_LAYERS, 6),
                                     ("float32", LMT_TP_FP32_LAYERS,
                                      LMT_TP_FP32_STEPS)):
            tr = _lmtt_trainer(_lmtt_cfg(layers, dtype), tmp, seed, steps,
                               dev)
            state = _lmtt_run(tr, steps)
            refs[dtype] = tr.rec
            print(f"[lm_tp_train] one device ({dtype}, {layers} layers): "
                  f"loss {[round(r['loss'], 5) for r in tr.rec]}, grad_norm "
                  f"{[round(r['grad_norm'], 5) for r in tr.rec]}, host s a "
                  f"step {[round(r['s'], 3) for r in tr.rec]}; state "
                  f"{ {k: round(v / 1e9, 3) for k, v in _state_bytes(state).items()} } GB, "
                  f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del state, tr
            gc.collect()
            torch.cuda.empty_cache()
        bcfg = _bert_train_cfg()
        tr = _lmtt_trainer(bcfg, tmp, seed, BERT_TP_TRAIN_STEPS, dev,
                           batch=BERT_TP_BATCH, seq=BERT_TP_SEQ, norms=True)
        bstate = _lmtt_run(tr, BERT_TP_TRAIN_STEPS)["params"]
        refs["bert"] = tr.rec
        del tr
    part("one-device references")

    counts = dict.fromkeys(_train_counters(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _Ranks(4, tmp)
        try:
            # a. gemma3_4b over dp, tp+dp, tp
            for name, shape, steps in LMT_TP_PARTS:
                ckpt = os.path.join(tmp, name)
                fault = LMT_TP_FAULT if steps == 6 else None
                res = ranks.run({
                    "name": name, "kind": "train", "what": "lm",
                    "shape": shape, "layers": LMT_LAYERS,
                    "dtype": "bfloat16", "steps": steps, "seed": seed,
                    "ckpt_dir": ckpt, "fault": fault,
                    "fit": fault is not None})
                tag = f"[lm_tp_train] a. {name} {shape}"
                for r, rank in enumerate(res):
                    check(rank["restarts"] == (1 if fault else 0) and
                          rank["fired"] == ([fault] if fault else []),
                          f"{tag} rank {r}: {rank['restarts']} restarts, "
                          f"faults fired {rank['fired']}")
                    check(rank["step"] == steps, f"{tag} rank {r}: "
                          f"optimizer step {rank['step']}")
                    check(all(v == 0 for v in rank["launches"].values()),
                          f"{tag} rank {r}: a dense step launched "
                          f"{rank['launches']}")
                ran = [r["step"] for r in res[0]["rec"]]
                print(f"{tag}: steps run {ran} ({res[0]['restarts']} "
                      f"restart), {res[0]['wall']:.1f} s; checkpoint "
                      f"saves / restores / waits (rank 0, s) "
                      f"{[(k, round(t, 2)) for k, t in res[0]['io']]}; "
                      f"local shapes "
                      f"{ {k: v for k, v in res[0]['local_shapes'].items() if 'blocks/[0]' in k or 'embed' in k} }")
                _print_rank_steps(tag, res)
                worst = _lmtt_compare(tag, res, refs["bfloat16"],
                                      "bfloat16")
                print(f"{tag}: loss {[r['loss'] for r in res[0]['rec']]}; "
                      f"against one device: loss {worst['loss']:.3e}, "
                      f"grad_norm {worst['grad_norm']:.3e} relative (bar "
                      f"{TOL_MESH_TRAIN['bfloat16']})")
                last = res[0]["rec"][-1]["step"]
                one_last = {r["step"]: r for r in refs["bfloat16"]}[last][
                    "masks"]
                same = sum(int((res[0]["masks_last"][k] == m).sum())
                           for k, m in one_last.items())
                total = sum(m.size for m in one_last.values())
                print(f"{tag}: step {last}'s masks {same} of {total} blocks "
                      f"equal to one device's")
                rec[name] = {"worst": worst, "wall": res[0]["wall"],
                             "peak_gib": [x["peak_gib"] for x in res],
                             "steps": [_step_stats(x) for x in
                                       res[0]["rec"]]}
                if name == "tp+dp":
                    tpdp = [{k: r[k] for k in ("step", "loss", "grad_norm")}
                            for r in res[0]["rec"]]
                if name == "dp":
                    shutil.rmtree(ckpt, ignore_errors=True)
            part("a. gemma3_4b bf16 over dp, tp+dp, tp")
            # the fp32 copies at 2 layers
            for name, shape in (("dp", (4, 1)), ("tp", (1, 4))):
                res = ranks.run({
                    "name": f"{name} fp32", "kind": "train", "what": "lm",
                    "shape": shape, "layers": LMT_TP_FP32_LAYERS,
                    "dtype": "float32", "steps": LMT_TP_FP32_STEPS,
                    "seed": seed, "ckpt_dir": os.path.join(tmp, "fp32")})
                tag = f"[lm_tp_train] a. fp32 copy {name} {shape}"
                _print_rank_steps(tag, res)
                worst = _lmtt_compare(tag, res, refs["float32"], "float32")
                print(f"{tag}: loss {[r['loss'] for r in res[0]['rec']]}, "
                      f"grad_norm {[r['grad_norm'] for r in res[0]['rec']]}"
                      f"; against one device: loss {worst['loss']:.3e}, "
                      f"grad_norm {worst['grad_norm']:.3e} relative (bar "
                      f"{TOL_MESH_TRAIN['float32']})")
                rec[f"{name} fp32"] = worst
            part("a. fp32 copies")

            # b. the (2, 2) step-4 checkpoint on other shapes
            ckpt = os.path.join(tmp, "tp+dp")
            meta = CheckpointStore(ckpt).meta(LMT_TP_CKPT_EVERY)
            check(meta.get("mesh", {}).get("shape") == [2, 2],
                  f"the (2, 2) checkpoint's meta {meta.get('mesh')}")
            for shape, steps in (((1, 4), 2), ((4, 1), 0)):
                res = ranks.run({
                    "name": f"restore {shape}", "kind": "train",
                    "what": "restore", "shape": shape, "layers": LMT_LAYERS,
                    "dtype": "bfloat16", "seed": seed, "ckpt_dir": ckpt,
                    "step": LMT_TP_CKPT_EVERY, "steps": steps,
                    "scratch_dir": os.path.join(tmp, "scratch")})
                tag = f"[lm_tp_train] b. (2, 2) step-4 checkpoint at {shape}"
                for r, rank in enumerate(res):
                    check(not rank["bad"], f"{tag} rank {r}: leaves not "
                          f"bitwise their shard: {rank['bad'][:5]}")
                print(f"{tag}: {res[0]['n']} leaves bitwise their shard of "
                      f"the file on every rank, restore "
                      f"{[round(x['restore_s'], 2) for x in res]} s")
                if steps:
                    _print_rank_steps(tag, res)
                    worst = _lmtt_compare(tag, res, tpdp, "bfloat16")
                    print(f"{tag}: steps 4-5 from it against the (2, 2) "
                          f"run's own steps 4-5 after its restart: loss "
                          f"{worst['loss']:.3e}, grad_norm "
                          f"{worst['grad_norm']:.3e} relative")
            tr = _lmtt_trainer(cfg, os.path.join(tmp, "scratch1"), seed, 1,
                               dev)
            t0 = time.perf_counter()
            state = tr.restore_state(CheckpointStore(ckpt),
                                     LMT_TP_CKPT_EVERY, tr.init_state())
            restore_s = time.perf_counter() - t0
            bad, n = _ckpt_mismatches(state, ckpt, LMT_TP_CKPT_EVERY, None)
            check(not bad, f"[lm_tp_train] b. one device: leaves not bitwise "
                  f"the file's: {bad[:5]}")
            print(f"[lm_tp_train] b. (2, 2) step-4 checkpoint on one device: "
                  f"{n} leaves bitwise, restore {restore_s:.2f} s, "
                  f"{sum(x.numel() * x.element_size() for x in leaves(state)) / 1e9:.2f} GB")
            del state, tr
            shutil.rmtree(ckpt, ignore_errors=True)
            part("b. restores")

            # c. BERT-base over (1, 4), masks against one device's
            res = ranks.run({"name": "bert (1, 4)", "kind": "train",
                             "what": "bert", "shape": (1, 4), "seed": seed,
                             "steps": BERT_TP_TRAIN_STEPS,
                             "ckpt_dir": os.path.join(tmp, "bert")})
            tag = "[lm_tp_train] c. BERT-base (1, 4)"
            _print_rank_steps(tag, res)
            worst = _lmtt_compare(tag, res, refs["bert"], "float32")
            n, diff, margins = _mask_near_ties(tag, res[0]["rec"],
                                               refs["bert"], bcfg.sparsity)
            print(f"{tag}: {BERT_TP_TRAIN_STEPS} steps, loss "
                  f"{[round(r['loss'], 6) for r in res[0]['rec']]}; against "
                  f"one device: loss {worst['loss']:.3e}, grad_norm "
                  f"{worst['grad_norm']:.3e} relative; masks: {n} blocks "
                  f"compared over the steps, {diff} differ (each a near-tie, "
                  f"printed)")
            rec["bert"] = {"worst": worst, "blocks": n, "differ": diff}

            # the hand-off, then the dp packed step
            spec = ServingSpec(tile=(128, 128), prune="none", fuse_qkv=True,
                               cross_layer_union=True,
                               backend="plan_pallas")
            servable = prepare_servable(bstate, bcfg, spec, device=dev)
            del bstate
            packs = servable.packs
            check(len(packs) == 4 * bcfg.n_layers,
                  f"{len(packs)} packed projections")
            pipe = DataPipeline(DataConfig(seq_len=BERT_TP_SEQ,
                                           global_batch=BERT_TP_BATCH,
                                           vocab_size=bcfg.vocab_size))
            batches = [pipe.batch_at(100 + i)
                       for i in range(BERT_TP_PACKED_STEPS)]
            pipe.close()
            opt = AdamWConfig(peak_lr=1e-4, warmup_steps=2, total_steps=10,
                              weight_decay=0.01)
            step = make_train_step(bcfg, opt, packs=packs)
            params, one = servable.params, []
            ost = init_opt_state(params, opt)
            for b in batches:
                params, ost, m = step(params, ost, {
                    k: torch.from_numpy(v).to(dev, torch.int64)
                    for k, v in b.items()})
                one.append({k: float(v) for k, v in m.items()})
            del params, ost
            res = ranks.run({"name": "packed dp (4, 1)", "kind": "train",
                             "what": "packed", "shape": (4, 1),
                             "params": servable.params, "packs": packs,
                             "batches": batches})
            tag = "[lm_tp_train] c. packed fine-tuning dp (4, 1)"
            want = dict.fromkeys(counts, 0)
            want.update(plan_dds=len(packs), plan_dds_t=len(packs),
                        plan_sddmm=len(packs))
            for r, rank in enumerate(res):
                for i, x in enumerate(rank["rec"]):
                    check(x["launches"] == want, f"{tag} rank {r} step {i}: "
                          f"launches {x['launches']}, the routing {want}")
                    check(x["rows"] == BERT_TP_BATCH // 4,
                          f"{tag}: rank {r} ran {x['rows']} rows")
                    for k in counts:
                        counts[k] += x["launches"][k]
            worst = {"loss": 0.0, "grad_norm": 0.0}
            for i, w in enumerate(one):
                first = res[0]["rec"][i]
                for r, rank in enumerate(res):
                    for k in worst:
                        check(rank["rec"][i][k] == first[k], f"{tag}: step "
                              f"{i} {k} differs between ranks 0 and {r}")
                for k in worst:
                    rel = abs(first[k] - w[k]) / abs(w[k])
                    worst[k] = max(worst[k], rel)
                    check(rel <= TOL_PACKED_STEP, f"{tag}: step {i} {k} "
                          f"{first[k]!r} against one device's {w[k]!r}")
            print(f"{tag}: launches a rank a step {res[0]['rec'][0]['launches']}"
                  f" (= the routing: {len(packs)} packed projections); loss "
                  f"{[round(x['loss'], 6) for x in res[0]['rec']]} against "
                  f"one device's {[round(x['loss'], 6) for x in one]}: "
                  f"{worst['loss']:.3e}, grad_norm {worst['grad_norm']:.3e} "
                  f"relative (bar {TOL_PACKED_STEP})")
            _print_rank_steps(tag, res)
            rec["packed"] = worst
            del servable, packs
            part("c. BERT-base")
        finally:
            ranks.close()
    print(f"[lm_tp_train] summary {json.dumps(rec, default=str)}")
    return counts


# --------------------------------------------------------------------------
# phase 4i: lm_pipe_compress -- block-sparse gradient compression over a
# data axis and GPipe over a "pipe" axis, four ranks sharing the card
# --------------------------------------------------------------------------

#: a. BERT-base over dp (4, 1): (8, 384) batches, 2 rows a rank, 3 steps
PC_STEPS = 3
PC_BATCH, PC_SEQ = 8, 384
PC_RANKS = 4
#: density 1.0 against the dense mean: only the order of the fp32 sums
#: differs
TOL_DENSE_MEAN = 1e-6
#: b. gemma3_4b at full width, 4 stages of one period (5 local + 1 global)
#: each; M microbatches of (1, PIPE_SEQ)
PIPE_STAGES, PIPE_M, PIPE_SEQ = 4, 6, 512
#: the GPipe gradients against autograd through the sequential run, of each
#: leaf's max|g|: bf16, and an fp32 copy of 2 layers a stage that tells a
#: wrong schedule from rounding
TOL_PIPE_GRAD = {"bfloat16": 1e-3, "float32": 1e-5}
#: the forward, where it is not bitwise, of max|y|
TOL_PIPE_FWD = 1e-3


def _pc_bert_cfg():
    from repro_torch.configs import get_config
    cfg = get_config("bert_base")
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.dtype)
          == (12, 768, 3072, 30522, "float32"),
          "not BERT-base at full width and depth, fp32")
    return cfg


def _pc_opt():
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(peak_lr=1e-4, warmup_steps=2, total_steps=10,
                       weight_decay=0.01)


def _pc_rows(batch, rank, dev):
    """Data rank ``rank``'s rows of a global batch (its contiguous block)."""
    import numpy as np
    import torch
    n = PC_BATCH // PC_RANKS
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[rank * n:(rank + 1) * n])).to(dev, torch.int64)
        for k, v in batch.items()}


def _pc_grads(params, cfg, rows):
    from repro_torch.launch.steps import make_loss_fn, value_and_grad
    loss, _, grads = value_and_grad(make_loss_fn(cfg), params, rows)
    return loss, grads


def _pc_sync_mesh(grads, errs, ccfg, mesh):
    """This rank's gradients -> (their mean over "data", the new error
    buffers): the compressible leaves through ``compressed_allreduce``, the
    rest in one fp32 ``all_reduce`` (summed in rank order), then divided."""
    import torch
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.optim.compression import (compressed_allreduce,
                                               compressible)
    gs, es = leaves(grads), leaves(errs)
    out, new = list(gs), list(es)
    dense = [i for i, g in enumerate(gs) if not compressible(g, ccfg)]
    summed = mesh.all_reduce(torch.cat([gs[i].reshape(-1) for i in dense]),
                             "data") / mesh.shape["data"]
    for i, part in zip(dense, torch.split(summed, [gs[i].numel()
                                                   for i in dense])):
        out[i] = part.view_as(gs[i])
    for i, g in enumerate(gs):
        if compressible(g, ccfg):
            out[i], new[i] = compressed_allreduce(g, es[i], ccfg, "data",
                                                  mesh)
    return unflatten(grads, out), unflatten(errs, new)


def _pc_sync_peers(grads, errs, ccfg):
    """One process standing in for ``_pc_sync_mesh`` over the ranks'
    gradients ``grads[r]`` and buffers ``errs[r]``: each rank's blocks
    compressed by the same functions and added in peer order, the rest
    summed in rank order. Returns (the mean, every rank's new buffers)."""
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.optim.compression import (compress, compressible,
                                               decompress)
    import torch
    n = len(grads)
    gs, es = [leaves(g) for g in grads], [leaves(e) for e in errs]
    mean, new = [], [list(e) for e in es]
    for i, g0 in enumerate(gs[0]):
        if compressible(g0, ccfg):
            parts = [compress(g[i], e[i], ccfg) for g, e in zip(gs, es)]
            summed = decompress(torch.cat([p[0] for p in parts]),
                                torch.cat([p[1] for p in parts]), g0.shape,
                                ccfg)
            mean.append((summed / n).to(g0.dtype))
            for r, p in enumerate(parts):
                new[r][i] = p[2]
        else:
            s = g0.clone()
            for g in gs[1:]:
                s += g[i]
            mean.append(s / n)
    return (unflatten(grads[0], mean),
            [unflatten(errs[r], new[r]) for r in range(n)])


def _pc_reference(params, cfg, batches, dev):
    """The one-process plain run of part a: per step the four ranks'
    gradients from their rows, synced by ``_pc_sync_peers``, AdamW.
    Returns each step's params and the four ranks' error buffers."""
    from repro_torch.optim.adamw import adamw_update, init_opt_state
    from repro_torch.optim.compression import (CompressionConfig,
                                               init_error_buffers)
    ccfg, opt = CompressionConfig(), _pc_opt()
    errs = [init_error_buffers(params, ccfg) for _ in range(PC_RANKS)]
    ost = init_opt_state(params, opt)
    refs = []
    for batch in batches:
        grads = [_pc_grads(params, cfg, _pc_rows(batch, r, dev))[1]
                 for r in range(PC_RANKS)]
        synced, errs = _pc_sync_peers(grads, errs, ccfg)
        params, ost, m = adamw_update(synced, ost, params, opt)
        refs.append({"params": params, "errs": errs,
                     "grad_norm": float(m["grad_norm"])})
    return refs


def _pc_unequal(tree, ref):
    """Paths of the leaves of ``tree`` not bitwise those of ``ref``."""
    import torch
    from repro_torch.core.tree import flatten_with_path, leaves, path_name
    return [path_name(p) for (p, x), y in zip(flatten_with_path(tree),
                                              leaves(ref))
            if not torch.equal(x, y)]


def _pc_full_density(grads, mesh):
    """Worst relative gap over the compressible leaves between
    ``compressed_allreduce`` at density 1.0 (no error) and the dense mean
    (an fp32 all_reduce over "data", divided)."""
    import torch
    from repro_torch.core.tree import leaves
    from repro_torch.optim.compression import (CompressionConfig,
                                               compressed_allreduce,
                                               compressible)
    ccfg = CompressionConfig(density=1.0)
    worst = 0.0
    for g in leaves(grads):
        if compressible(g, ccfg):
            mean, err = compressed_allreduce(
                g, torch.zeros_like(g, dtype=torch.float32), ccfg, "data",
                mesh)
            check(not err.any(), "density 1.0 left an error")
            dense = mesh.all_reduce(g, "data") / mesh.shape["data"]
            worst = max(worst, float((mean - dense).abs().max()
                                     / dense.abs().max()))
    return worst


def _rank_pc_compress(job, mesh, dev, say):
    """Part a on one data rank: three compressed-DP steps from the
    parent's initial params, each checked bitwise against the one-process
    run's params and this rank's error buffers."""
    import torch
    from repro_torch.core.tree import map_with_path
    from repro_torch.optim.adamw import adamw_update, init_opt_state
    from repro_torch.optim.compression import (CompressionConfig,
                                               init_error_buffers)
    cfg, ccfg, opt = _pc_bert_cfg(), CompressionConfig(), _pc_opt()
    params = map_with_path(lambda _, x: x.clone(), job.pop("params"))
    errs = init_error_buffers(params, ccfg)
    ost = init_opt_state(params, opt)
    r = mesh.coord("data")
    rec = []
    for step, (batch, ref) in enumerate(zip(job["batches"], job["refs"])):
        rows = _pc_rows(batch, r, dev)
        mesh.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = _pc_grads(params, cfg, rows)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        synced, errs = _pc_sync_mesh(grads, errs, ccfg, mesh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params, ost, m = adamw_update(synced, ost, params, opt)
        torch.cuda.synchronize()
        x = {"s": time.perf_counter() - t0, "sync_s": t2 - t1,
             "stats": copy.deepcopy(mesh.stats), "loss": float(loss),
             "grad_norm": float(m["grad_norm"]),
             "bad": (_pc_unequal(params, ref["params"])
                     + [f"err {p}" for p in _pc_unequal(errs,
                                                        ref["errs"][r])])}
        if step == 0:
            x["dense_rel"] = _pc_full_density(grads, mesh)
        rec.append(x)
        say(f"step {step}: {x['s']:.3f} s, sync {x['sync_s']:.3f} s")
    return {"rec": rec}


def _pipe_cfg(dtype="bfloat16"):
    """gemma3_4b at full width, one period (5 local + 1 global) a stage."""
    import dataclasses
    cfg = dataclasses.replace(_lm_config(), n_layers=6 * PIPE_STAGES,
                              dtype=dtype)
    prefix, pattern, n_periods, suffix = cfg.layer_plan()
    check(not prefix and not suffix and n_periods == PIPE_STAGES
          and len(pattern) == 6, f"{cfg.n_layers} gemma3_4b layers are not "
          f"{PIPE_STAGES} periods of 6")
    return cfg


def _pipe_kinds(cfg, fp32_copy):
    """The layer kinds of a stage: the period's six, or for the fp32 copy
    its first local and its global layer."""
    pattern = cfg.layer_plan()[1]
    return (pattern[0], pattern[-1]) if fp32_copy else tuple(pattern)


def _pipe_layer_fn(cfg, kinds, packs=None, calls=None):
    """``layer_fn(stage params, h)``: the LM's own layer body
    (``models/lm._apply_layer``) over ``kinds`` at positions
    0..PIPE_SEQ-1, with the servable's union packs when given."""
    import torch
    from repro_torch.models import lm
    positions = torch.arange(PIPE_SEQ, device="cuda")[None, :]

    def layer_fn(p, h):
        if calls is not None:
            calls[0] += 1
        for i, kind in enumerate(kinds):
            h, _ = lm._apply_layer(p[i], h, cfg, kind, positions=positions,
                                   packs=lm._layer_packs(packs,
                                                         f"blocks/{i}"))
        return h
    return layer_fn


def _pipe_stage(blocks, s):
    """Stage ``s`` of a stage-stacked tree (views)."""
    from repro_torch.core.tree import map_with_path
    return map_with_path(lambda _, t: t[s], blocks)


def _pipe_reference(layer_fn, blocks, xs, ct):
    """One device: the stages in order on each microbatch -> y; then, last
    microbatch first, autograd of <ct, y> through all of them, each
    stage's parameter gradient accumulated in fp32 (the schedule's order)
    and cast once. Returns (y, dX, the gradients stacked like
    ``blocks``)."""
    import torch
    from repro_torch.core.tree import leaves, map_with_path, unflatten
    stages = [_pipe_stage(blocks, s) for s in range(PIPE_STAGES)]
    with torch.no_grad():
        ys = []
        for x in xs:
            for st in stages:
                x = layer_fn(st, x)
            ys.append(x)
    live = [[t.detach().requires_grad_(True) for t in leaves(st)]
            for st in stages]
    trees = [unflatten(st, lv) for st, lv in zip(stages, live)]
    acc = [[torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for t in lv] for lv in live]
    dxs = [None] * xs.shape[0]
    for mb in reversed(range(xs.shape[0])):
        x = xs[mb].detach().requires_grad_(True)
        h = x
        for tr in trees:
            h = layer_fn(tr, h)
        got = torch.autograd.grad(h, [x] + [t for lv in live for t in lv],
                                  ct[mb])
        dxs[mb] = got[0]
        it = iter(got[1:])
        for a_s in acc:
            for a in a_s:
                a += next(it).float()
        del h, got
    flat = [torch.stack([a_s[j] for a_s in acc]).to(leaves(blocks)[j].dtype)
            for j in range(len(acc[0]))]
    return (torch.stack(ys), torch.stack(dxs),
            unflatten(map_with_path(lambda _, t: t, blocks), flat))


def _rank_pipe(job, mesh, dev, say):
    """Part b on one stage: the rank's block of one of the stage-stacked
    params, the pipeline forward and backward, checked against the
    parent's sequential run."""
    import torch
    from repro_torch.core.tree import (flatten_with_path, leaves,
                                       map_with_path, path_name)
    from repro_torch.launch.pipeline import pipeline_apply
    fp32 = job["dtype"] == "float32"
    cfg = _pipe_cfg(job["dtype"])
    calls = [0]
    layer_fn = _pipe_layer_fn(cfg, _pipe_kinds(cfg, fp32), calls=calls)
    s = mesh.coord("pipe")
    local = map_with_path(lambda _, t: t[s:s + 1].detach().requires_grad_(
        True), job["blocks"])
    x = job["xs"].detach().requires_grad_(True)
    mesh.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = pipeline_apply(layer_fn, local, x, mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fwd = (calls[0], copy.deepcopy(mesh.stats))
    y.backward(job["ct"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    def rel(a, b):
        a, b = a.detach().float(), b.float()
        return float((a - b).abs().max() / b.abs().max())
    grads = {path_name(p): (rel(t.grad[0], r[s]), torch.equal(t.grad[0],
                                                               r[s]))
             for (p, t), r in zip(flatten_with_path(local),
                                  leaves(job["grads"]))}
    say(f"{job['dtype']}: forward {t1 - t0:.3f} s, backward {t2 - t1:.3f} s")
    return {"y_equal": torch.equal(y, job["y"]), "y_rel": rel(y, job["y"]),
            "dx_equal": torch.equal(x.grad, job["dx"]),
            "dx_rel": rel(x.grad, job["dx"]), "grads": grads,
            "fwd_s": t1 - t0, "bwd_s": t2 - t1, "fwd_calls": fwd[0],
            "calls": calls[0], "fwd_stats": fwd[1],
            "stats": copy.deepcopy(mesh.stats), "stage": s}


def _rank_pipe_packed(job, mesh, dev, say):
    """Part c on one stage: the servable's period-stacked values (the
    whole stack, shared by the parent) through the pipeline with the union
    packs, K1 launches counted around the forward alone."""
    import torch
    from repro_torch.kernels import plan_dds
    from repro_torch.launch.pipeline import pipeline_apply
    cfg = _pipe_cfg()
    layer_fn = _pipe_layer_fn(cfg, _pipe_kinds(cfg, False), job["packs"])
    mesh.reset_stats()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan_dds.launches = 0
        y = pipeline_apply(layer_fn, job["blocks"], job["xs"], mesh)
        torch.cuda.synchronize()
        launches = plan_dds.launches
    say(f"packed forward {time.perf_counter() - t0:.3f} s")
    return {"y_equal": torch.equal(y, job["y"]),
            "y_rel": float((y.float() - job["y"].float()).abs().max()
                           / job["y"].float().abs().max()),
            "launches": launches, "s": time.perf_counter() - t0,
            "stats": copy.deepcopy(mesh.stats)}


def phase_lm_pipe_compress(seed: int, card: str):
    """Block-sparse gradient compression and the GPipe schedule on four
    processes sharing the card, their collectives through CUDA IPC staging
    buffers (as lm_tp_train). a. BERT-base over dp (4, 1): 3 steps of
    (8, 384), 2 rows a rank, the compressible leaves through
    ``compressed_allreduce`` (density 0.05), the rest an fp32 all-reduce,
    AdamW; every rank's params and error buffers bitwise a one-process run
    that compresses the same four ranks' gradients with the same functions;
    density 1.0 against the dense mean (1e-6); wire bytes. b. gemma3_4b at
    full width, 4 stages of one period, 6 microbatches of (1, 512) bf16:
    the pipeline forward on every rank bitwise (or 1e-3 of max|y|) one
    device's 24 layers in order, the gradients of every stage's params and
    of X within 1e-3 of max|g| of autograd through that run, an fp32 copy
    of 2 layers a stage within 1e-5. c. the same periods packed by
    ``prepare_servable`` (plan_pallas) through the pipeline: bitwise the
    sequential packed run, K1 launches a rank = 24 packs x 6 microbatches.
    Returns the K1 launches."""
    import gc
    import torch
    from repro_torch.core.tree import leaves, map_with_path
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.kernels import plan_dds
    from repro_torch.models.api import init_model
    from repro_torch.optim.compression import CompressionConfig, compressible
    from repro_torch.serving import ServingSpec, prepare_servable
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[lm_pipe_compress] {card}; four ranks share the card, their "
          f"collectives through CUDA IPC staging buffers, so no time here "
          f"says anything of pipeline or compressed-DP speed")
    marks = [time.perf_counter()]

    def part(name):
        gc.collect()
        torch.cuda.empty_cache()
        marks.append(time.perf_counter())
        print(f"[lm_pipe_compress] {name}: {marks[-1] - marks[-2]:.1f} s")

    counts = {"plan_dds": 0}
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _Ranks(PC_RANKS, tmp)    # they start while the parent works
        try:
            # a. BERT-base compressed DP
            bcfg = _pc_bert_cfg()
            params = init_model(seed, bcfg, device=dev)
            pipe = DataPipeline(DataConfig(seq_len=PC_SEQ,
                                           global_batch=PC_BATCH,
                                           vocab_size=bcfg.vocab_size))
            batches = [pipe.batch_at(200 + i) for i in range(PC_STEPS)]
            pipe.close()
            refs = _pc_reference(params, bcfg, batches, dev)
            ccfg = CompressionConfig()
            packed = [x for x in leaves(params) if compressible(x, ccfg)]
            dense_bytes = sum(x.numel() * 4 for x in packed)
            part("a. the one-process reference")
            res = ranks.run({"name": "compress dp (4, 1)",
                             "kind": "train", "what": "compress",
                             "phase": "lm_pipe_compress",
                             "shape": (PC_RANKS, 1),
                             "axes": ("data", "model"), "params": params,
                             "batches": batches, "refs": refs})
            tag = "[lm_pipe_compress] a. BERT-base dp (4, 1)"
            for r, rank in enumerate(res):
                for i, x in enumerate(rank["rec"]):
                    check(not x["bad"], f"{tag} rank {r} step {i}: not "
                          f"bitwise the one-process run: {x['bad'][:5]}")
                    check(x["grad_norm"] == refs[i]["grad_norm"],
                          f"{tag} rank {r} step {i}: grad_norm "
                          f"{x['grad_norm']!r}, one process "
                          f"{refs[i]['grad_norm']!r}")
                check(rank["rec"][0]["dense_rel"] <= TOL_DENSE_MEAN,
                      f"{tag} rank {r}: density 1.0 is "
                      f"{rank['rec'][0]['dense_rel']:.3e} from the dense "
                      f"mean (bar {TOL_DENSE_MEAN})")
            st = res[0]["rec"][0]["stats"]
            wire = st["all_gather:data"]["bytes"]
            rest = st["all_reduce:data"]["bytes"]
            print(f"{tag}: {len(packed)} compressed leaves "
                  f"({sum(x.numel() for x in packed) / 1e6:.1f} M of "
                  f"{sum(x.numel() for x in leaves(params)) / 1e6:.1f} M "
                  f"params); {PC_STEPS} steps, every rank's params and error "
                  f"buffers bitwise the one-process run after each; "
                  f"grad_norm {[r['grad_norm'] for r in refs]}; wire bytes "
                  f"a rank a step on those leaves {wire} (all_gather, "
                  f"{st['all_gather:data']['calls']} calls) against "
                  f"{dense_bytes} for their dense fp32 all-reduce: "
                  f"{wire / dense_bytes:.4f}; the other leaves {rest} "
                  f"(one all_reduce); density 1.0 against the dense mean "
                  f"{max(x['rec'][0]['dense_rel'] for x in res):.3e} "
                  f"(bar {TOL_DENSE_MEAN})")
            print(f"{tag}: host s a step (ranks) "
                  f"{[[round(x['s'], 3) for x in rk['rec']] for rk in res]}"
                  f", of it in the sync "
                  f"{[round(x['sync_s'], 3) for x in res[0]['rec']]} "
                  f"(rank 0); peak "
                  f"{[round(x['peak_gib'], 2) for x in res]} GiB a rank "
                  f"({card})")
            del params, refs, res
            part("a. BERT-base compressed DP")

            # b. gemma3_4b GPipe, bf16 then the fp32 copy
            cfg = _pipe_cfg()
            full = init_model(seed, cfg, device=dev)
            blocks = full["blocks"]
            gen = torch.Generator(device="cuda").manual_seed(seed + 7)
            shape = (PIPE_M, 1, PIPE_SEQ, cfg.d_model)
            xs = torch.randn(shape, generator=gen, device=dev)
            ct = torch.randn(shape, generator=gen, device=dev)
            for dtype in ("bfloat16", "float32"):
                fp32 = dtype == "float32"
                c = _pipe_cfg(dtype)
                kinds = _pipe_kinds(c, fp32)
                stage_blocks = (tuple(map_with_path(lambda _, t: t.float(),
                                                    blocks[i])
                                      for i in (0, len(blocks) - 1))
                                if fp32 else blocks)
                x_in = xs.to(c.tdtype)
                c_in = ct.to(c.tdtype)
                y, dx, grads = _pipe_reference(_pipe_layer_fn(c, kinds),
                                               stage_blocks, x_in, c_in)
                part(f"b. {dtype}: the sequential reference")
                res = ranks.run({"name": f"pipe {dtype}",
                                 "kind": "train", "what": "pipe",
                                 "phase": "lm_pipe_compress",
                                 "shape": (PIPE_STAGES,), "axes": ("pipe",),
                                 "dtype": dtype, "blocks": stage_blocks,
                                 "xs": x_in, "ct": c_in, "y": y, "dx": dx,
                                 "grads": grads})
                _pipe_report(dtype, len(kinds), res, x_in)
                del y, dx, grads, stage_blocks, res
                part(f"b. GPipe {dtype}")

            # c. the same periods packed, through K1
            spec = ServingSpec(tile=(128, 128), sparsity=0.8, prune="tied",
                               fuse_qkv=True, backend="plan_pallas")
            del blocks
            servable = prepare_servable(full, cfg, spec, device=dev)
            del full
            k1 = sum(1 for k in servable.packs if k.startswith("blocks/"))
            sv_blocks = servable.params["blocks"]
            layer_fn = _pipe_layer_fn(cfg, _pipe_kinds(cfg, False),
                                      servable.packs)
            x_in = xs.to(cfg.tdtype)
            with torch.no_grad():
                plan_dds.launches = 0
                ys = []
                for x in x_in:
                    for s in range(PIPE_STAGES):
                        x = layer_fn(_pipe_stage(sv_blocks, s), x)
                    ys.append(x)
                y = torch.stack(ys)
                torch.cuda.synchronize()
                seq_launches = plan_dds.launches
            check(seq_launches == k1 * PIPE_STAGES * PIPE_M,
                  f"the sequential packed run launched {seq_launches} K1")
            res = ranks.run({"name": "pipe packed", "kind": "train",
                             "what": "pipe_packed",
                             "phase": "lm_pipe_compress",
                             "shape": (PIPE_STAGES,),
                             "axes": ("pipe",), "blocks": sv_blocks,
                             "packs": servable.packs, "xs": x_in, "y": y})
            tag = "[lm_pipe_compress] c. GPipe through K1"
            want = k1 * PIPE_M
            for r, rank in enumerate(res):
                check(rank["y_equal"], f"{tag} rank {r}: outputs not "
                      f"bitwise the sequential packed run "
                      f"({rank['y_rel']:.3e} of max|y|)")
                check(rank["launches"] == want, f"{tag} rank {r}: "
                      f"{rank['launches']} K1 launches, the routing {want}")
                counts["plan_dds"] += rank["launches"]
            print(f"{tag}: {k1} packs a stage (fused QKV, attn wo, ffn wi "
                  f"and wo of its {len(cfg.pattern)} layers), union-packed "
                  f"over the {PIPE_STAGES} periods; "
                  f"K1 launches a rank {[x['launches'] for x in res]} (= "
                  f"{k1} x {PIPE_M} microbatches, no bubble tick computes); "
                  f"outputs bitwise the sequential packed run on every "
                  f"rank; host s {[round(x['s'], 3) for x in res]}; peak "
                  f"{[round(x['peak_gib'], 2) for x in res]} GiB a rank")
            del servable, sv_blocks, y, res
            part("c. GPipe through K1")
        finally:
            ranks.close()
    return counts


def _pipe_report(dtype, layers, res, xs):
    """Part b's checks and prints for one dtype."""
    tag = f"[lm_pipe_compress] b. GPipe {dtype}, {layers} layers a stage"
    bar = TOL_PIPE_GRAD[dtype]
    m = xs.shape[0]
    mb_bytes = xs[0].numel() * xs.element_size()
    worst = {"y": 0.0, "dx": 0.0, "grad": 0.0}
    equal = {"y": True, "dx": True, "grad": True}
    for r, rank in enumerate(res):
        check(rank["y_equal"] or rank["y_rel"] <= TOL_PIPE_FWD,
              f"{tag} rank {r}: forward {rank['y_rel']:.3e} of max|y| "
              f"from the sequential run (bar {TOL_PIPE_FWD})")
        check(rank["dx_rel"] <= bar, f"{tag} rank {r}: dX "
              f"{rank['dx_rel']:.3e} of max|g| (bar {bar})")
        for name, (rel, eq) in rank["grads"].items():
            check(rel <= bar, f"{tag} rank {r}: d{name} {rel:.3e} of "
                  f"max|g| (bar {bar})")
            worst["grad"] = max(worst["grad"], rel)
            equal["grad"] &= eq
        worst["y"] = max(worst["y"], rank["y_rel"])
        worst["dx"] = max(worst["dx"], rank["dx_rel"])
        equal["y"] &= rank["y_equal"]
        equal["dx"] &= rank["dx_equal"]
        check(rank["fwd_calls"] == m and rank["calls"] == 2 * m,
              f"{tag} rank {r}: layer_fn ran {rank['fwd_calls']} / "
              f"{rank['calls']} times, not {m} / {2 * m}")
        pp = rank["stats"]["ppermute:pipe"]
        check(pp["calls"] == 2 * (m + PIPE_STAGES - 2)
              and pp["bytes"] == pp["calls"] * mb_bytes,
              f"{tag} rank {r}: ppermute {pp}")
    pp = res[0]["stats"]["ppermute:pipe"]

    def said(key):
        return "bitwise" if equal[key] else f"{worst[key]:.3e} of max|.|"
    print(f"{tag}: on every rank against the sequential run: forward "
          f"{said('y')}, dX {said('dx')}, every stage's parameter "
          f"gradients {said('grad')} (bar {bar} of max|g|); a rank: "
          f"layer_fn {res[0]['fwd_calls']} forward + "
          f"{res[0]['calls'] - res[0]['fwd_calls']} recomputed, ppermute "
          f"{pp['calls']} calls, {pp['bytes']} bytes; host s forward "
          f"{[round(x['fwd_s'], 3) for x in res]}, backward "
          f"{[round(x['bwd_s'], 3) for x in res]}; peak "
          f"{[round(x['peak_gib'], 2) for x in res]} GiB a rank")


# --------------------------------------------------------------------------
# phase 4j (not in the default run): lm_tp_trace -- where a mesh rounds
# differently from one device
# --------------------------------------------------------------------------

#: the M of mamba2's in_proj GEMM on the mesh: a decode step over 4 slots,
#: a 20-token prompt's bucket, a 300-token prompt's
TRACE_GEMM_M = (4, 32, 512)


def phase_lm_tp_trace(seed: int, card: str):
    """The tool for a bf16 reading near its bar: (a) mamba2_780m's
    ``in_proj`` (6448 x 1536, bf16) cut into a (1, 4) mesh's column blocks,
    each block as a bf16 GEMM of its own (cuBLAS's reduced-precision split-K
    reductions on and off) and through ``common.block_matmul``, against the
    rows of one device's whole GEMM: the share of outputs that differ; (b)
    the residual's gap to one device after every layer of a one-pass
    prefill (37 tokens) and the decode step after it, mamba2 at full width
    and depth over tp (1, 4), bf16 and fp32."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models.api import init_model
    from repro_torch.models.common import block_matmul
    from repro_torch.serving import ServingSpec, prepare_servable
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(0.02 * rng.randn(6448, 1536).astype(
        np.float32)).to(dev, torch.bfloat16)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    for m in TRACE_GEMM_M:
        x = torch.from_numpy(rng.randn(1, m, 1536).astype(np.float32)).to(
            dev, torch.bfloat16)
        whole = torch.matmul(x, w.t())
        share = {}
        for name, fn, reduced in (
                ("bf16 GEMM, reduced-precision reductions", torch.matmul,
                 True),
                ("bf16 GEMM, fp32 reductions", torch.matmul, False),
                ("block_matmul", None, flag)):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
                = reduced
            diff = 0
            for r in range(4):
                wb = w[r * 1612:(r + 1) * 1612]
                blk = (fn(x, wb.t()) if fn is not None
                       else block_matmul(x, wb))
                diff += int((blk != whole[..., r * 1612:(r + 1) * 1612]).sum())
            share[name] = diff / whole.numel()
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
        print(f"[lm_tp_trace] {card}: mamba2 in_proj at M {m}, a (1, 4) "
              f"mesh's column blocks against one device's whole bf16 GEMM, "
              f"share of outputs that differ: "
              f"{ {k: round(v, 4) for k, v in share.items()} }")
    vocab = _recurrent_config("mamba2_780m").vocab_size
    prompt = {"tokens": np.random.RandomState(seed + 11).randint(
        0, vocab, 37).tolist()}
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _Ranks(4, tmp)
        try:
            for dtype in ("bfloat16", "float32"):
                cfg = dataclasses.replace(_recurrent_config("mamba2_780m"),
                                          dtype=dtype)
                sv = prepare_servable(
                    init_model(seed, cfg, device=dev), cfg,
                    ServingSpec(tile=(128, 128), prune="none",
                                backend="plan", mesh_shape=(1, 4),
                                partition="tp"), device=dev, place=False)
                sub = sv.init_cache(1, 1280)
                padded = np.zeros((64,), np.int32)
                padded[:37] = prompt["tokens"]
                _, row = sv.prefill_row(sub, torch.from_numpy(padded).to(dev),
                                        37)
                prompt["next"] = int(row.argmax())
                one = _trace_layers(sv, prompt)
                res = ranks.run({"name": f"trace {dtype}", "kind": "trace",
                                 "servable": (sv.params, sv.cfg, sv.spec,
                                              sv.packs, sv.export_stats),
                                 "prompt": prompt})
                for what, got, ref in (("prefill", res[0][0], one[0]),
                                       ("decode", res[0][1], one[1])):
                    gaps = [float((a - b).abs().max() / b.abs().max())
                            for a, b in zip(got, ref)]
                    print(f"[lm_tp_trace] mamba2_780m ({dtype}) tp (1, 4) "
                          f"{what}: the residual's max|d| / max|h| against "
                          f"one device after layers 1, 6, 12, .., 48: "
                          f"{[f'{g:.2e}' for g in gaps[:1] + gaps[5::6]]}")
                del sv, res, one
        finally:
            ranks.close()
    return {}


def _sum_group(recs):
    """A group of per-shape records summed (one layer's four projections):
    the kernel-line keys."""
    if not recs:
        return {k: None for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")}
    out = {"max_abs_err": max(r["max_abs_err"] for r in recs)}
    for key in ("ms", "ms_cold", "plain_ms", "bound_ms", "library_ms",
                "library_ms_cold", "general_ms"):
        if all(key in r for r in recs):
            out[key] = sum(r[key] for r in recs)
    out["bound_by"] = ("bytes" if sum(r["bytes_ms"] for r in recs)
                       >= sum(r["operations_ms"] for r in recs)
                       else "operations")
    return out


def _instances_of(recs):
    """K5's and K7's instance at each timed shape."""
    inst = {r["shape"]: r["instance"] for r in recs if r["instance"]}
    return {"instance": inst} if inst else {}


def _k1k6_record(name, source, replaces, launches, groups, by_path):
    """The kernels-line record of K1 or K6: the top-level numbers are one
    BERT-base layer at M=384 (as before the instances); each timed group
    (BERT M=384, gemma3_4b M=4 and M=1024) rides along summed, with the
    instance it ran and its shapes."""
    return {
        "name": name, "route": "cuda", "source": source,
        "shared_source": COMMON_SOURCE, "replaces": replaces,
        "launches": launches, "launches_by_path": by_path,
        **_sum_group(groups.get("bert_m384", [])),
        "instance": {label: recs[0]["instance"]
                     for label, recs in groups.items() if recs},
        "groups": {label: _sum_group(recs) for label, recs in groups.items()},
        "per_shape": groups}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="kernels,serving,serving_quant,serving_auto,"
                            "lm_serving,lm_serving_quant,lm_serving_sched,"
                            "lm_families,lm_recurrent,lm_training,lm_tp,"
                            "lm_tp_families,lm_tp_recurrent,lm_tp_train,"
                            "lm_pipe_compress,training")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    t_run = time.perf_counter()
    marks = [("build", t_run)]

    def done(name):
        now = time.perf_counter()
        print(f"[phase] {name}: {now - marks[-1][1]:.1f} s (run "
              f"{now - t_run:.1f} s)")
        marks.append((name, now))

    try:
        card = phase_build()
        done("build")
        per_shape, bwd_shapes, decode_shapes, launches = {}, {}, {}, {}
        quant_shapes, masked_shapes = {}, []
        if "kernels" in phases:
            per_shape = phase_kernels(args.seed)
            bwd_shapes = phase_backward_kernels(args.seed)
            decode_shapes = phase_decode_kernels(args.seed)
            quant_shapes = phase_quant_kernels(args.seed)
            masked_shapes = phase_masked_kernels(args.seed)
            done("kernels")
        if "serving" in phases:
            launches["bert"] = phase_serving(args.seed, args.requests)
            done("serving")
        if "serving_quant" in phases:
            launches["serving_quant"] = phase_serving_quant(args.seed,
                                                            args.requests)
            done("serving_quant")
        if "serving_auto" in phases:
            launches.update(phase_serving_auto(args.seed, args.requests))
            done("serving_auto")
        lm_fp = lm_tokens = None
        if "lm_serving" in phases:
            launches["lm"], lm_fp, lm_tokens = phase_lm_serving(args.seed)
            done("lm_serving")
        if "lm_serving_quant" in phases:
            launches["lm_serving_quant"] = phase_lm_serving_quant(
                args.seed, lm_fp, lm_tokens)
            done("lm_serving_quant")
        if "lm_serving_sched" in phases:
            launches["lm_serving_sched"] = phase_lm_serving_sched(
                args.seed, card, lm_fp)
            done("lm_serving_sched")
        del lm_fp
        if "lm_families" in phases:
            import gc
            gc.collect()
            torch.cuda.empty_cache()
            launches["lm_families"] = phase_lm_families(args.seed, card)
            done("lm_families")
        if "lm_recurrent" in phases:
            import gc
            gc.collect()
            torch.cuda.empty_cache()
            launches["lm_recurrent"] = phase_lm_recurrent(args.seed, card)
            done("lm_recurrent")
        if "lm_training" in phases:
            import gc
            gc.collect()
            torch.cuda.empty_cache()
            launches["lm_training"] = phase_lm_training(args.seed, card)
            done("lm_training")
        if "lm_tp" in phases:
            import gc
            gc.collect()
            torch.cuda.empty_cache()
            launches["lm_tp"] = phase_lm_tp(args.seed, card, args.requests)
            done("lm_tp")
        if "lm_tp_families" in phases:
            import gc
            gc.collect()
            torch.cuda.empty_cache()
            launches["lm_tp_families"] = phase_lm_tp_families(args.seed,
                                                              card)
            done("lm_tp_families")
        if "lm_tp_recurrent" in phases:
            import gc
            gc.collect()
            torch.cuda.empty_cache()
            launches["lm_tp_recurrent"] = phase_lm_tp_recurrent(args.seed,
                                                                card)
            done("lm_tp_recurrent")
        if "lm_tp_train" in phases:
            import gc
            gc.collect()
            torch.cuda.empty_cache()
            launches["lm_tp_train"] = phase_lm_tp_train(args.seed, card)
            done("lm_tp_train")
        if "lm_pipe_compress" in phases:
            import gc
            gc.collect()
            torch.cuda.empty_cache()
            launches["lm_pipe_compress"] = phase_lm_pipe_compress(args.seed,
                                                                  card)
            done("lm_pipe_compress")
        if "lm_tp_trace" in phases:
            launches["lm_tp_trace"] = phase_lm_tp_trace(args.seed, card)
            done("lm_tp_trace")
        if "lm_tp_cards" in phases:
            launches["lm_tp_cards"] = phase_lm_tp_cards(args.seed, card)
            done("lm_tp_cards")
        if "training" in phases:
            launches["training"] = phase_training(args.seed)
            done("training")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    def total(name):
        counts = [c[name] for c in launches.values() if name in c]
        return sum(counts) if counts else None

    records = [_k1k6_record("plan_dds", KERNEL_SOURCE, REPLACES,
                            total("plan_dds"), per_shape,
                            {k: c.get("plan_dds") for k, c in
                             launches.items()})]
    # K4 and K5 at the four BERT-base projection shapes at M=3072 (times
    # summed: one layer's packed backward); launches over every entry point
    for name, kernel, entries, source, replaces in (
            ("dds", "K4", ("dds", "dds_t", "plan_dds_t"), DDS_SOURCE,
             DDS_REPLACES),
            ("sddmm", "K5", ("sddmm", "plan_sddmm"), SDDMM_SOURCE,
             SDDMM_REPLACES)):
        recs = bwd_shapes.get(name, [])
        counts = [total(e) for e in entries]
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (sum(c for c in counts if c is not None)
                         if any(c is not None for c in counts) else None),
            "launches_by_entry": dict(zip(entries, counts)),
            "launches_by_path": {
                k: sum(c.get(e, 0) for e in entries)
                for k, c in launches.items() if any(e in c for e in entries)},
            **_sum_group(recs), **_instances_of(recs), "per_shape": recs})
    # K2 at the ring shape (29 of gemma3_4b's 34 layers), K3 at the paged
    # global shape; every shape's numbers ride along in per_shape
    for name, main_shape, shapes in (
            ("flash_decode", "ring_1024",
             ("ring_1024", "global_1280") + tuple(
                 f"{c[0]}_{c[4]}" for c in DECODE_FAMILY_SHAPES)),
            ("paged_flash_decode", "paged_1280",
             ("paged_1280",) + tuple(
                 f"{c[0]}_paged_{c[4]}" for c in DECODE_FAMILY_SHAPES
                 if c[6]))):
        rec = decode_shapes.get(main_shape, {})
        records.append({
            "name": name, "route": "cuda", "source": DECODE_SOURCE,
            "replaces": DECODE_REPLACES[name], "launches": total(name),
            "max_abs_err": rec.get("max_abs_err"), "ms": rec.get("ms"),
            "ms_cold": rec.get("ms_cold"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"), "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms"),
            "library_ms_cold": rec.get("library_ms_cold"),
            "per_shape": {k: decode_shapes[k] for k in shapes
                          if k in decode_shapes},
            "launches_by_path": {k: c.get(name) for k, c in launches.items()
                                 if name in c}})
    # K6 as K1; K7 at the four BERT-base projection shapes (times summed)
    records.append(_k1k6_record(
        "plan_dds_q", QUANT_SOURCE, QUANT_REPLACES, total("plan_dds_q"),
        quant_shapes, {k: c.get("plan_dds_q") for k, c in launches.items()
                       if "plan_dds_q" in c}))
    recs = masked_shapes
    records.append({
        "name": "masked_matmul", "route": "cuda", "source": MASKED_SOURCE,
        "replaces": MASKED_REPLACES, "launches": total("masked_matmul"),
        "launches_by_path": {k: c.get("masked_matmul") for k, c in
                             launches.items() if "masked_matmul" in c},
        **_sum_group(recs), **_instances_of(recs), "per_shape": recs})
    print(f"card: {card}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
