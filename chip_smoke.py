#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py                 # every phase below
  python3 chip_smoke.py --train-spread  # the build and [train-spread] only

``--train-spread`` measures what the recurrent families' sharded train
limits after the first step are set against: the unsharded bf16 step's
distance from the unsharded f32 step on the same weights and tokens
(zamba2-7b and rwkv6-7b at SHARDED_FAMILY_RUNS' depths, 2 steps each);
it prints no result line.

Phases (any failure exits non-zero; nothing is caught and swallowed):
  1. card and build: the card's name and power limit, then the CUDA
     kernels built from ``src/repro_torch/csrc`` (one nvcc per source, in
     parallel), with the build seconds and ptxas's register report; the
     bf16 tensor-core variants of L1 and L2 (``*_sm90``), their 3xTF32 f32
     variants, B1, B2, L3, L4 and L5 must not spill;
  2. kernel parity: each kernel (B1 bmf_precision, B2 bmf_sweep) against
     its plain PyTorch version, fp32 and bf16, at the phase-c bucket shape
     of phase 4's data (which holds all-padding tiles and empty rows),
     timed with CUDA events (warm-up, median of several runs), with its
     achieved TB/s;
  3. the quickstart on the card: ``mini``, ``run_full_bmf`` and a 2×2
     stacked ``run_pp`` with the fused sweep; PP must beat the mean
     predictor;
  4. the main path at full size: the MovieLens-20M shape of the paper's
     Table 1 (138,493 × 27,278, 144 ratings/row, K = 10, true rank 8), 10%
     held out, a 16×4 grid, and a stacked ``run_pp`` once with the fused
     sweep (B2) and once with the sufficient-statistics kernel (B1). Each
     run must give a finite RMSE below the mean predictor and launch its
     kernel. Then the paper's K = 100 shape: Netflix (Table 1: 480,189 x
     17,770, 209 ratings/row, K = 100, true rank 12) with its rows cut to
     1/8 (60,023 x 17,770, ~12.5M ratings), 10% held out, on the 8 x 2
     grid that ``suggest_grid`` picks for 16 blocks (the 32 x 2 grid that
     64 blocks give the full matrix has the same column split and ~104
     ratings per block-row; a 16 x 4 grid would make phase c's Lam 6.8
     and 8.0 GB): B1, its tensor-core Gram kernel above K = 16, against
     its plain version at this run's phase-c bucket, fp32 and bf16, timed
     beside its bound (the plain version once); then a stacked
     ``run_pp`` with ``use_kernel=True``, 8 sweeps, which must beat the
     mean predictor, launch B1, record no health-guard fault and keep
     the peak device memory below 80 GB (as every BMF run must);
     then the same run through the streaming executor (W = 2, depth 2:
     ``[netflix-streaming]``), held to the stacked run's RMSE within
     PP_RMSE_TOL, its peak memory printed beside the stacked run's and
     its ``peak_window_blocks`` within W·(depth + 1);
     between the two shapes, at the MovieLens-20M shape with the fused
     sweep: ``[main:async]`` and ``[main:streaming]`` (W = 4, depth 2),
     each held to the stacked fused-sweep run's RMSE within PP_RMSE_TOL
     and below the mean predictor (pad and chain seconds: the host's
     padding time and the first dispatch to last resolve; streaming also
     prints ``peak_window_blocks`` × the largest ``block_bytes``);
     since PR 21, the placements of ``core.topology`` on the one card,
     with the fused sweep on the same shape's first 1/PLACEMENT_ROWS of
     the rows (``cut_rows``, the same grid), each held to a stacked run
     of that cut (``[main:fused-sweep-rows/4]``): ``[main:async-groups]``
     (async on Topology(4, 1): 4 groups, a stream each) and
     ``[main:streaming-groups]`` (Topology(2, 1), W = 4 per group, depth
     2), each within PP_RMSE_TOL of the stacked run, with wall, pad and
     chain seconds and peak memory; ``[main:sharded]``: the sharded
     executor on Topology(2, 2) (2 groups of 2 data slots) in the
     'gather' (within PP_RMSE_TOL), 'psum' (within PSUM_RMSE_TOL) and
     'scatter' (below the mean predictor and within SCATTER_RMSE_TOL)
     modes, with the transposed shard planes' bytes, the comm bytes per
     block-sweep, and B1 (the psum/scatter V-step) and B2 (the U-step)
     launches; ``[group-faults]``: async on Topology(4, 1) with group 1
     dead from its first dispatch (quarantine_after = 1: bitwise the
     clean grouped run, one quarantine) and with group 1 slowed under
     speculate_at = GROUP_SPECULATE_AT (one resolve per block, twice,
     bitwise equal);
     ``[bmf-sync]``: one async block dispatch and one ``_aggregate_axis``
     under ``torch.cuda.set_sync_debug_mode("error")``;
     ``[serve]``: the stacked fused-sweep result (no retraining) as a
     ``PosteriorStore`` with 8 item slots (build seconds and bytes; the
     test RMSE of its posterior-mean scores and, per side, the aggregated
     precisions that are indefinite before its PD projection), then
     a ``MicroBatchRouter`` with ``bmf_serve``'s defaults (k = 10, batches
     of up to 32, 64 seen, 8 folded, a 2 ms budget) serving 4,096
     real-user requests (``bmf_serve.build_requests``: each masks up to 64
     of its training items) in mean and in Thompson mode after one warm-up
     batch each, and 256 cold starts (user -1, 8 folded ratings of a real
     user); QPS, p50/p99, dispatches, batch shapes and peak memory; every
     mean answer, cold starts included, within 1e-5 of a float64
     brute-force k-th best on the host; every Thompson answer 10 valid,
     distinct, unseen items; one warm scoring call per mode under
     ``set_sync_debug_mode("error")``;
     ``[lint]`` (PR 22): ``launch/bmf_lint.py`` on the card (every
     executor on 1x1 and on Topology(2, 2) as streams, serving, the
     kernels, and each pass's negative case on CUDA tensors, which must
     fire while its clean twin stays quiet): zero violations, B1 and B2
     in the op traces; one stacked phase-c chain of the 16x4 grid at full
     width (B = 45, one sweep; the fused sweep fp32 and bf16, and
     use_kernel) recorded and checked by the op passes against
     ``materialization_budget`` at its dims, with its largest buffer and
     the ops seen; the recompilation budget of the grid's plans; B1 and
     B2 counted under the ``lint`` path; then B2's enqueue cost per call
     at the async B = 1 shape (raw ctypes launcher, the wrapper's launch
     path with its ``note_kernel`` hook, and as a
     ``torch.library.custom_op``);
     ``[table2]``: ``benchmarks/bench_rmse.py``'s methods and
     configurations on the MovieLens-20M shape with its rows cut to 1/8
     (17,311 x 27,278: the baselines' padded CSR of the whole matrix does
     not fit at full size), 10% held out: PP on the 4-block grid and full
     BMF (40 samples, burn-in 13), ALS 20 iterations on its dense path
     and through B1 (within 1e-4 of each other; B1's launches in the
     kernels line under ``als``), blocked SGD 30 epochs (each round's
     minibatch loop one CUDA graph replay) and CCD++ 10 iterations, each
     below the mean predictor; then B1 at the whole matrix's padded CSR,
     both sides, against its plain version;
     ``[dryrun]``, after the quickstart: the MovieLens-20M
     phase-c bucket's stacked chain (B2, 2 sweeps) planned on ``meta``
     by ``launch.bmf_dryrun`` and run on the card on the bucket's planes
     with N(0, I) priors: the planned B1/B2 launches must equal the
     counted ones and the planned peak sit within DRYRUN_PEAK_TOL of
     ``max_memory_allocated``; each side's launch timed beside its
     roofline (the plan's, every slot, and at its live slots); then
     ``bmf_dryrun --pp-engine`` at the reference's defaults on ``meta``
     (seconds, each record's dominant term and peak); and in the Netflix
     phase, after B1's parity, the same check at its K = 100 bucket (B1
     plus the torch Cholesky). Every B1/B2 bound comes from
     ``roofline.op_cost`` of one launch (``launch_bound``);
  5. LLM kernel parity: L1 flash_attention and L3 decode_attention against
     their plain versions, bf16 and fp32 (L1 and L2 have two CUDA
     variants: bf16 runs the sm90 tensor-core kernel, fp32 the f32
     kernel), at the serve path's shapes
     (Qwen3-4B: H = 32, Hkv = 8, hd = 128, batch 8): L1 causal at the
     4,000-token prompt, with a 1,024 window, and non-causal at 4,096; L3
     over a full 4,096-slot cache, a ragged cache with empty slots, and a
     ring-shuffled cache under a window. L1 is compared on 2 of the 8
     sequences (the plain version's f32 scores at 8 x 4,000 would take
     16 GB); every kernel is timed at the full shape, beside its plain
     version, its bound, its achieved TB/s and one PyTorch call (SDPA) as
     the library yardstick; L3 and its SDPA as one call between events
     (``ms``, ``library_ms``: the measure of the earlier rows, which counts
     the host's enqueue) and beside it as device time per call (20 calls
     in a CUDA graph: ``device_ms_per_call``,
     ``library_device_ms_per_call``); and the serving shapes': L1 causal
     over one 32,768-token prompt, held on its last 1,024 query rows (the
     plain version's scores for all would not fit), and L3 over 32,768
     filled slots at batch 8 with its split plan;
  6. the LLM serve path at full width: Qwen3-4B, all 36 layers, seeded
     random bf16 weights made on the card; 8 sequences of 4,096 synthetic
     tokens; ``make_prefill_step`` consumes 4,000 of them into a
     4,096-slot cache and ``make_serve_step`` feeds the other 96 one by
     one (teacher-forced) until the cache is full. Logits must be finite,
     L1 must launch 36 times, all on the sm90 kernel, and L3 36 x 96
     times, and for 2 sequences every step's logits must agree with the
     port's ``forward`` over all 4,096 tokens run through the plain
     attention versions; then ``[serving-shapes]``: the reference's
     ``INPUT_SHAPES`` on Qwen3-4B at full width and depth (see
     SHAPE_SEQ's comment): ``[shape-prefill32k]`` (``prefill_32k``'s
     prompt at batch 1; the prefill of S + 1 tokens against the prefill
     of S into S + 1 slots plus one decode step), ``[int8-decode]``
     (``decode_32k``'s cache at batch 8 in int8, whose attention is the
     plain ``layers.flash_attend`` and launches no kernel, against
     bf16; each cache's bytes equal to its spec on ``meta``) and
     ``[long-context]`` (``long_500k``'s 8,192-slot ring after a
     16,384-token prompt against an unringed cache with the same window
     mask), each with exact launch counts;
  7. L2 parity: L2 (flash attention backward) against its plain version
     on the same (q, k, v, o, do, lse), bf16 and fp32, at the train path's
     attention shape (B = 2, S = 4,096, H = 32, Hkv = 8, hd = 128): causal,
     window 1,024 and non-causal, compared on the first sequence (the
     plain version's f32 (S, S) tiles per head); L1's lse against the
     plain logsumexp; the autograd Function (L1 + L2) against autograd
     through the plain attention; every case timed beside its plain
     version, its bound and SDPA's backward as the library yardstick;
  8. the LLM train path at full width: Qwen3-4B with its depth cut to 8
     of 36 layers (AdamW's f32 state for all 36 would take 70.6 GB),
     seeded random f32 master weights made on the card; first, for one
     sequence, the loss and gradients through the kernels against the
     same through the plain attention and against an f32 pass; then
     TRAIN_STEPS (4) ``make_train_step`` steps on batches of 4 x 4,096
     synthetic tokens in
     2 microbatches with remat: losses and grad norms finite, L1 launched
     32 and L2 16 times per step, every launch on the sm90 kernels; the
     last step under ``torch.profiler``; then ``[sharded-llm]``: Qwen3-4B's
     steps as SPMD programs (``models.sharded``) on ``make_debug_mesh(2,
     2)``, its 4 slots streams on the card. Serve at full depth: phase 6's
     8 x 4,000-token prompts and 32 decode steps against the unsharded
     serve on the card (LOGIT_TOL worst step, LOGIT_MEDIAN_TOL median),
     L1 144 per prefill and L3 144 per step; train at 8 layers with this
     phase's batches: the first batch's sharded gradients against the
     unsharded ones (TRAIN_* limits), then 3 steps each (loss and grad
     norm per step within TRAIN_LOSS_TOL / TRAIN_NORM_TOL), L1 128 and L2
     64 per step; s/step, tokens/s, busy share, peak memory and the
     collective bytes by kind per slot; then the LLM dry run
     (``launch.dryrun.lower_one``) of train_4k and decode_32k on the
     16 x 16 mesh, mixtral-8x7b's prefill_32k (the moe FSDP branch: its
     expert weights all-gathered over 'data' in every layer) and
     whisper-medium's decode_32k (the cross cache), and the debug mesh's
     plans of the three runs, whose launches per slot must be the counted
     ones over 4; then ``[sharded-vlm]``, ``[sharded-moe]`` and
     ``[sharded-audio]``: internvl2-1b, granite-moe-1b-a400m and
     whisper-medium at full width on the same mesh, each
     serving phase 6's prompt batch (internvl2: 256 stub image positions,
     then text; whisper: its text over 8 x 1,500 stub frames) and 8
     decode steps against the unsharded serve on the card under its own
     LOGIT_TOL / LOGIT_MEDIAN_TOL (granite over the (sequence, step)
     pairs at which an untimed replay kept the unsharded run's experts at
     every layer; the flips are printed), then the first train batch's
     sharded gradients against the unsharded ones (TRAIN_* limits) and 2
     train steps of each at 12 of their 24 (decoder) layers (loss and
     grad norm within TRAIN_LOSS_TOL /
     TRAIN_NORM_TOL), with L1 / L3 / L2 at 4 x the unsharded counts, all
     sm90, and the debug mesh's plans of each run (planned x 4 =
     counted); then ``[sharded-hybrid]`` and ``[sharded-ssm]``: zamba2-7b
     and rwkv6-7b the same way, serving at full width and depth (L4 / L5
     per layer and slot in the prefill; zamba2's shared block L1 per
     application and slot, L3 per application, slot and step) and
     training at full width with the depth of SHARDED_FAMILY_RUNS
     (zamba2 7 of 81 layers: a full group, the shared block and a
     remainder group; rwkv6 4 of 32; after the first step zamba2's loss
     within HYBRID_STEP_LOSS_TOL and rwkv6's grad norm within
     SSM_STEP_NORM_TOL, the other two under TRAIN_*); then
     ``[sharded-int8]``: Qwen3-4B's
     int8 cache decoded through the sharded step from empty (16 prompt
     tokens, 8 steps) against the unsharded int8 decode, no kernel
     launched, each slot's cache bytes its spec's on ``meta``; and the
     late ``[sharded-llm-dryrun]`` records (zamba2 decode_32k, rwkv6
     prefill_32k, Qwen3-4B decode_32k with the int8 cache) on 16 x 16;
  9. L1/L3 parity at zamba2's shared attention block (MHA, H = Hkv = 32,
     hd = 112), bf16 and fp32: causal prefill at 4,000 tokens and decode
     over a full 4,096-slot ring, timed as in phase 5; and L2 at its train
     shape (B = 2, S = 4,096, causal; the sm90 kernel in its 128-column
     tiles, the f32 kernel's own hd 112 instantiation) with the autograd
     Function, as in phase 7;
 10. L4 (ssd_chunk) and L5 (wkv6) parity, f32, against their plain
     chunked versions at the serve path's shapes (B = 8, S = 4,096;
     zamba2: H = 112, P = N = 64; rwkv6: H = 64, N = 64): the serve
     path's own call (zero state, a 4,000-token prompt padded with
     identity steps), a random state over 4,096 steps, and strong decay
     (a ~ -2 per step for L4, log w ~ -1 for L5); each timed beside its
     plain version, its bound and its achieved TB/s (L4 and L5: the bytes
     bound, their bf16 split products and the f32 operations of their
     first designs); then ``[scan-train-parity]``: the training scans
     (the route a prompt takes under autograd: the plain chunked scans,
     each chunk checkpointed, as the reference trains) at the full head
     counts, B 1, S 512, f32, against L4 / L5 (y and the final state,
     SCAN_TRAIN_TOL) and their gradients with respect to every input
     against autograd through the sequential oracles (SCAN_GRAD_TOL),
     a random layer's decay and strong decay;
 11. the hybrid serve path at full width and depth: zamba2-7b, all 81
     Mamba2 layers and the shared block (13 applications), and
 12. the ssm serve path: rwkv6-7b, all 32 layers; each with the traffic
     of phase 6 (8 x 4,000-token prompts into a 4,096-token context, 96
     teacher-forced decode steps), exact launch counts (zamba2: L4 81, L1
     13 per prefill, all sm90, L3 13 per decode step; rwkv6: L5 32),
     finite logits, and every step's logits of 2 sequences against the
     port's forward through the plain kernel versions, under phase 6's
     limits; each model is freed before the next is built;
 13. L1/L3 parity at the moe and vlm families' hd 64 attention, bf16 and
     fp32, timed as in phase 5: Granite-MoE (H = 16 over Hkv = 8, GQA
     group 2) and InternVL2 (H = 14 over Hkv = 2, group 7), causal
     prefill at 4,000 positions and decode over a full 4,096-slot cache;
 14. the moe and vlm serve paths with phase 6's traffic: ``[granite-serve]``
     (granite-moe-1b-a400m at full depth, 24 layers of 32 experts, top
     8), ``[mixtral-serve]`` (mixtral-8x7b at full width with its depth
     cut to MIXTRAL_LAYERS of 32, the cut and its reason printed: 93.4 GB
     of bf16 weights; its 4,096-token window makes the cache a ring,
     and it decodes RING_WRAP_STEPS steps past the context, so the ring
     wraps) and
     ``[internvl2-serve]`` (internvl2-1b at full depth; the prompt is 256
     image positions and 3,744 text tokens); exact launch counts (L1 one
     per layer per prefill, all sm90, L3 one per layer per decode step),
     peak memory below 80 GB, and the logits of 2 sequences against the
     port's forward through the plain attention, whose MoE layers take
     the tokens in the serve path's calls (the prompt in one, then one
     position at a time), within LOGIT_TOL (the worst step) and
     LOGIT_MEDIAN_TOL (the median decode step, and that of the steps
     past a wrapped ring); for the moe models an untimed second run of
     the serve path records which experts each layer kept for the
     checked tokens, LOGIT_TOL holds the steps at which it routed as the
     plain forward did, and it prints ``moe_dropped`` and the tokens that
     kept more than K experts (router ties);
 15. ``[moe-train]``: phase 8 for granite-moe-1b-a400m at full width and
     depth (24 layers): the one-sequence check under the TRAIN_* limits,
     then 4 steps with exact L1/L2 launch counts; the model-FLOP share
     counts the active parameters (router and top-8 experts);
 16. ``[whisper-parity]``: L1, L3 and L2 at whisper-medium's attention
     (MHA, H = Hkv = 16, hd 64: GQA group 1), bf16, against their plain
     versions and timed as in phases 5 and 7: L1 over the encoder's
     1,500 frames (non-causal, a ragged length), the decoder's causal
     4,000-token prompt and its cross-attention (4,000 queries over
     1,500 frames); L3 over a full 4,096-slot self cache and the
     1,500-slot cross cache; L2 (B = 2) over the frames and the
     cross-attention of 4,096 queries over 1,500 frames;
 17. ``[whisper-serve]``: whisper-medium at full width and depth (24
     encoder and 24 decoder layers) with phase 6's text traffic, each
     prompt over 1,500 seeded stub frames: exact launch counts (L1 72 per
     prefill: 24 encoder, 24 self, 24 cross, all sm90; L3 48 per decode
     step), and the logits of 2 sequences against the serve path itself
     replayed through the plain kernel versions, bf16 and f32 (its
     decode adds no position to the token, as the reference's does not,
     so it is not its forward), within LOGIT_TOL and LOGIT_MEDIAN_TOL;
 18. ``[whisper-train]``: phase 8 for whisper-medium at full width and
     depth, 4 x 4,096 tokens over 4 x 1,500 frames: the one-sequence
     check under the TRAIN_* limits, then 4 steps with L1 288 and L2 144
     launches a step (72 attention calls a microbatch, L1 again under
     remat);
 19. ``[hybrid-train]`` and ``[ssm-train]``: phase 8 for zamba2-7b at
     full width with 15 of 81 Mamba2 layers (two full groups and a
     remainder of 3; the shared block applied twice) and for rwkv6-7b at
     full width with 8 of 32 layers: the one-sequence check (zamba2 under
     the TRAIN_* limits; rwkv6, whose step launches no kernel, bf16
     against f32 under the SSM_TRAIN_* limits), then 4 steps with exact
     launch counts (zamba2: L1 8 and L2 4 a step, all sm90; neither
     launches L4 or L5, since a scan under autograd takes the training
     scan), s/step, tokens/s, model-FLOP share, peak memory below 80 GB
     and a device-only profile of the last step;
 20. ``[examples]``: the port's four ``examples/torch_*.py`` as
     subprocesses at their defaults, all started together (the LLM one
     for mixtral-8x7b, granite-moe-1b-a400m and whisper-medium); each
     must exit 0 with ``OK``;
 21. summary: one JSON line ``{"kernels": [...]}`` (L1 and L2 with each
     variant's launches and times, launches by path, the sharded paths'
     under ``serve_sharded`` / ``train_sharded`` and ``serve_sharded_vlm``
     / ``_moe`` / ``_audio`` / ``_hybrid`` / ``_ssm`` (and ``train_``) and
     ``serve_sharded_int8``; L4 and L5 by serve and train path, sharded
     too) and, last, the
     ``{"ok": true, "device": {...}}`` line. ``[time]`` lines give the
     run's seconds after each group of phases. Every profiled window
     traces the device's activity only (``device_profile``).

Without a GPU, or without the repository's ``src/repro_torch`` beside it,
it exits non-zero before printing any result.
"""
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# kernel vs plain version on the card, relative to the largest plain
# value: both sum the same f32 products in other orders (up to thousands
# of slots per row); B2 also factors and solves in another order, which
# the conditional precision's condition number amplifies
TOL = {"bmf_precision": 1e-4, "bmf_sweep": 1e-4}

# the main path's chain, cut to fit the smoke's time limit
SAMPLES, BURNIN = 8, 3
# an overlapped executor's PP RMSE against the stacked run of the same
# data and config on the card (ROADMAP §C: the port's card limit on a PP
# RMSE): the chains differ only in batch sizes, i.e. rounding
PP_RMSE_TOL = 1e-4
# [main:sharded]: the 'psum' mode reassociates the item statistics'
# sums (the reference's own limit on its composed chain), and 'scatter'
# samples V from per-shard draws, a different chain (the reference's
# limit, tests/test_topology.py)
PSUM_RMSE_TOL, SCATTER_RMSE_TOL = 1e-3, 0.15
# the placements of the new phases, every slot on the one card
ASYNC_GROUPS, STREAM_GROUPS, SHARDED = (4, 1), (2, 1), (2, 2)
# the placement runs ([main:async-groups], [main:streaming-groups],
# [main:sharded], [group-faults]) take the MovieLens shape's first
# 1/PLACEMENT_ROWS of the rows on the same 16 x 4 grid, held against a
# stacked run of that cut: each full-shape run spent ~15 s, mostly the
# host's padding, which scales with the rows
PLACEMENT_ROWS = 4
# [group-faults]: the watchdog floor (a healthy block resolves in well
# under it), and the straggler's delay and hedge: a twin needs an idle
# group, which this host-bound run has only where the ready queue runs
# dry, by which time the slow group's own rate has absorbed the delay
# (2 x that rate never fired on the card: PR 21 run 1), so the hedge
# fires at half the group's own expected span
GROUP_FLOOR_S, GROUP_SLOW_S, GROUP_SPECULATE_AT = 5.0, 3.0, 0.5

# the LLM serve path: Qwen3-4B at full width and depth, 8 sequences, a
# 4,000-token prompt into a 4,096-slot cache, then 96 decode steps; the
# recurrent families (zamba2, rwkv6) serve the same traffic
LLM_ARCH = "qwen3_4b"
HYBRID_ARCH, SSM_ARCH = "zamba2_7b", "rwkv6_7b"
LLM_BATCH, LLM_PROMPT, LLM_CONTEXT = 8, 4000, 4096
LLM_CHECK = 2              # sequences held against the plain forward
# L1/L3 kernel vs plain version on the card, relative to the largest plain
# value: fp32 differs only in summation order; bf16 results are rounded to
# bf16 from f32 values that differ in summation order, so they may land one
# bf16 step (2^-8) apart
ATTN_TOL = {"fp32": 1e-5, "bf16": 4e-3}
# serve path vs the port's forward with the plain kernel versions, both
# bf16: max |d logit| / rms(logits) over the real vocabulary, by model. On
# the H100 the plain bf16 forward of Qwen3-4B itself sits 0.091 from the
# f32 forward on the same weights (bf16 roundings through 36 random
# layers), and the serve path 0.088 from the plain bf16 forward; the limit
# is about twice that spread. Through zamba2-7b's 81 random layers bf16
# rounding moves the logits further: the plain bf16 forward sits 0.400
# from the f32 forward and the serve path 0.300 from the plain bf16
# forward (argmax agreement 0.969), so its limit is 0.6, 1.5x bf16
# rounding's own spread there. rwkv6-7b (0.133 and 0.217) keeps 0.2.
LOGIT_TOL = {LLM_ARCH: 0.2, HYBRID_ARCH: 0.6, SSM_ARCH: 0.2}
# and the serve path may be at most this much farther from the f32
# forward than the plain bf16 forward is (measured: 0.94x)
F32_GAP_TOL = 1.5
# the moe and vlm families, with phase 6's traffic: Granite-MoE and
# InternVL2 at full depth (InternVL2's prompt: 256 image positions and
# 3,744 text tokens), Mixtral at full width with its depth cut to 8 of 32
# layers (its 46.7e9 parameters take 93.4 GB in bf16, more than the card's
# 80 GB); then Granite's train step at full width and depth
MOE_ARCH, MIXTRAL_ARCH, VLM_ARCH = ("granite_moe_1b_a400m", "mixtral_8x7b",
                                    "internvl2_1b")
MIXTRAL_LAYERS = 8
# their LOGIT_TOL. internvl2 takes the dense models' 0.2: on the H100 its
# plain bf16 forward sits 0.088 from the f32 forward, the serve path
# 0.091 from the plain bf16 forward. For the moe models it holds the
# checked tokens (sequence, step) for which an untimed second run of the
# serve path kept, at every layer, the experts that the plain forward
# kept: a bf16 rounding that moves a token across the top-K threshold (a
# routing flip) moves its logits by up to an rms or more whatever the
# kernels do (mixtral, 8 layers, 8 steps past the ring: 1.203 at one
# step, and the plain bf16 forward 1.303 from the f32 one), and flips are
# common (a flip in either sequence at 90 of granite's 97 checked steps
# and 21 of mixtral's 105). The steps without one measured 0.0488
# (granite) and 0.0625 (mixtral), so the moe models take the dense
# models' 0.2 too; flips are counted and printed
LOGIT_TOL.update({MOE_ARCH: 0.2, MIXTRAL_ARCH: 0.2, VLM_ARCH: 0.2})
# LOGIT_MEDIAN_TOL bounds the median over the decode steps of the
# timed run's max |d logit| / rms(logits), which no single step (and no
# routing flip) can set, and, where the ring wraps, that of the steps past
# the context. On the H100 (serve path vs the plain bf16 forward):
# Qwen3-4B 0.0783, zamba2-7b 0.2421, rwkv6-7b 0.1133, granite-moe 0.1112,
# mixtral (8 layers) 0.0469 (past the ring 0.0469), internvl2 0.0734; each
# limit is about twice its reading
LOGIT_MEDIAN_TOL = {LLM_ARCH: 0.15, HYBRID_ARCH: 0.4, SSM_ARCH: 0.2,
                    MOE_ARCH: 0.2, MIXTRAL_ARCH: 0.1, VLM_ARCH: 0.15}
# mixtral's window (4,096) is the context, so its cache is a 4,096-slot
# ring: it decodes this many steps past the context, which wraps the ring
# over its oldest slots
RING_WRAP_STEPS = 8
# the audio family: whisper-medium at full width and depth (24 encoder
# and 24 decoder layers, MHA: GQA group 1), phase 6's text traffic over
# 8 x 1,500 seeded stub frames, and phase 8's train traffic (4 x 4,096
# tokens over 4 x 1,500 frames) at full depth. Its serve logits are held
# against the serve path replayed through the plain kernels (its decode
# adds no position to the token, as the reference's does not, so it is
# not its forward), under the dense models' max limit. On the H100 the
# plain bf16 replay sits 0.0588 from the f32 replay, and the serve path
# 0.0643 (max) and 0.0490 (median decode step) from the plain bf16
# replay; the median's limit is about twice its reading
WHISPER_ARCH = "whisper_medium"
LOGIT_TOL[WHISPER_ARCH] = 0.2
LOGIT_MEDIAN_TOL[WHISPER_ARCH] = 0.1

# the serving shapes (INPUT_SHAPES) on Qwen3-4B at full width and depth:
# [shape-prefill32k] one prompt of prefill_32k's 32,768 tokens (its batch
# of 32 cut to 1), held against the prefill of 32,768 tokens plus one
# decode step of the next; [int8-decode] decode_32k's 32,768-slot cache
# at batch 8 (of 128: the int8 cache of 128 rows would take 319 GB), a
# 16-token prompt decoded from the empty cache (the reference's int8
# route) and 16 teacher-forced steps (cut from 32 and 32 to keep the
# script in its time limit), int8 against the bf16 cache on the
# same tokens; [long-context] long_500k as the reference runs a dense
# model: long_context_window's 8,192-slot ring at batch 1, a 16,384-token
# prompt (full causal attention, the last 8,192 positions kept at
# ring-aligned slots), 32 decode steps that overwrite the oldest slots,
# against a 16,416-slot cache decoded with the same window mask
SHAPE_SEQ = 32_768
L1_LONG_CHECK_ROWS = 1024
INT8_BATCH, INT8_PROMPT, INT8_STEPS = 8, 16, 16
LONG_PROMPT, LONG_STEPS = 16_384, 32
# max |d logit| / rms(logits) limits of the three, each about twice its
# first reading on the H100 (NVIDIA H100 80GB HBM3, 700 W): the prefill
# of S + 1 tokens against the prefill of S and one decode step (L1
# against L3, both bf16: 0.1016); int8 against the bf16 cache over the
# steps (0.1679) and its median step (0.1406); the ring against the
# unringed cache (0.0704: the same prefill, bitwise, then L3 over 8,192
# ring slots against 16,416 masked ones, whose bf16 outputs round apart
# through 36 layers)
PREFILL32K_LOGIT_TOL = 0.2
INT8_LOGIT_TOL, INT8_LOGIT_MEDIAN_TOL = 0.35, 0.3
LONG_LOGIT_TOL = 0.15

# L4/L5 vs their plain chunked versions on the card, relative to the
# largest plain value (y and the final state): both f32; the kernels sum
# in 64-step chunks, the plain versions in the reference's 128-step chunks
SCAN_TOL = 1e-4
# [scan-train-parity]: the training scans (the plain chunked versions with
# each chunk checkpointed) at full head counts, B 1, S 512, f32. Their y
# and final state against L4 / L5: the reference's own limit between its
# Pallas scans and their oracles (tests/test_kernels.py), 2e-4 of the
# largest value. Their values and gradients with respect to every input
# against autograd through the sequential oracles: 2e-4 of each one's
# largest value, about 5x the CPU's gap at this shape with fewer heads
# (tests/test_torch_recurrent_train.py: 3.7e-5, A_log's gradient)
SCAN_TRAIN_B, SCAN_TRAIN_S = 1, 512
SCAN_TRAIN_TOL, SCAN_GRAD_TOL = 2e-4, 2e-4

# L2 parity at the train path's attention shape; the plain version's f32
# (S, S) tiles allow L2_CHECK sequences at a time
L2_BATCH, L2_SEQ, L2_CHECK = 2, 4096, 1
# L2 vs its plain version. fp32: 1e-4 of the largest plain value; both sum
# the same f32 products in another order over up to 4,096 terms, and
# ds = p (dp - D) cancels (each row sums to 0), so the error is relative to
# the terms, not to the result. bf16: the outputs are rounded from f32
# values that differ in summation order, so they may land one bf16 step
# apart: one step of the largest plain value (its ulp, 2^-8 to 2^-7 of it)
L2_TOL = {"fp32": 1e-4, "bf16": 1}
# L1's lse vs the plain logsumexp: the same f32 scores, another order
LSE_TOL = 1e-5
# the autograd Function (L1 + L2) vs autograd through the plain attention:
# fp32 as L2 alone; bf16 two bf16 steps of the largest plain value, one for
# the rounding of the result and one for D = rowsum(do * o), which L2 forms
# from o as L1 wrote it, rounded to bf16, where the plain path's autograd
# never rounds o
E2E_TOL = {"fp32": 1e-4, "bf16": 2}
# the train path's one-sequence check: the kernels' bf16 loss and gradients
# against the plain attention's bf16 ones. On the H100 the plain bf16 pass
# sits 8.1e-4 (loss), 8.9e-5 (1 - cosine of the gradients) and 2.6e-4
# (gradient norm ratio - 1) from the f32 pass on the same weights, and the
# kernels' pass 5.3e-5, 5e-6 and 3.6e-5 from the plain bf16 pass; the limits
# are about twice bf16 rounding's own spread
TRAIN_LOSS_TOL, TRAIN_COS_TOL, TRAIN_NORM_TOL = 2e-3, 2e-4, 5e-4

# the LLM train path: Qwen3-4B at full width, 8 of its 36 layers; 4 steps
# of 4 x 4,096 tokens in 2 microbatches (each f32 logits tensor 4.98 GB;
# cut from 6 steps to keep the script in its time limit)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 4, 4096, 2
TRAIN_STEPS = 4
# the sharded phases: SPMD programs on a 2 x 2 ('data', 'model') debug
# mesh, its 4 slots streams on the one card, each serving the serve
# phase's prompt batch at full width and depth and SHARDED_DECODE_STEPS
# decode steps, then SHARDED_TRAIN_STEPS steps of the train phase's
# traffic at full width, each held against the unsharded step on the card
# under the model's own limits. [sharded-llm]: Qwen3-4B, trained at
# TRAIN_LAYERS, with SHARDED_LLM_DECODE_STEPS and SHARDED_LLM_TRAIN_STEPS
SHARDED_MESH = (2, 2)
SHARDED_DECODE_STEPS, SHARDED_TRAIN_STEPS = 8, 2
SHARDED_LLM_DECODE_STEPS, SHARDED_LLM_TRAIN_STEPS = 32, 3
# then the families as (tag, arch, train depth): internvl2-1b,
# granite-moe-1b-a400m and whisper-medium at 12 of their 24 (decoder)
# layers (cut from all 24 to keep the script in its time limit),
# zamba2-7b at 7 of 81 layers (one full group of 6, the shared block, a
# remainder group of one: every branch of hybrid_groups) and rwkv6-7b at
# 4 of 32
SHARDED_FAMILY_RUNS = (("sharded-vlm", "internvl2_1b", 12),
                       ("sharded-moe", "granite_moe_1b_a400m", 12),
                       ("sharded-audio", "whisper_medium", 12),
                       ("sharded-hybrid", "zamba2_7b", 7),
                       ("sharded-ssm", "rwkv6_7b", 4))
# granite's sharded serve holds LOGIT_TOL over the (sequence, step) pairs
# at which its replay kept the unsharded serve's experts at every layer:
# at least this many of its 8 x 9 pairs (on the H100, 24 and 25 were kept
# in six runs; bf16 routing flips take the rest)
SHARDED_MOE_MIN_KEPT = 16
# granite-moe's unsharded train step is not deterministic on the card: its
# combine adds by atomics (``moe.combine``), so a rerun can flip a route
# (its step-1 moe_dropped read 0.605546-0.605552) and the update moves the
# next step. Its step-2 grad norm read 14.400216-14.408709 in seven runs
# (NVIDIA H100 80GB HBM3, 700 W), a range of 5.9e-4 of the value, beside
# the sharded step's 14.408345 in every run: the moe family's sharded
# steps after the first hold their grad norm to about twice that range
# (the first batch's gradients and step 1 keep TRAIN_*)
MOE_STEP_NORM_TOL = 1.2e-3
# the recurrent families' sharded train steps after the first: AdamW's
# first update turns each parameter by about lr along the sign of its
# gradient, so bf16 rounding's differences in small gradients move the
# next step. On the H100 (NVIDIA H100 80GB HBM3, 700 W) the sharded
# steps' step 2 sat, in every run (the sharded and unsharded steps are
# deterministic there), 2.639e-3 (zamba2-7b at 7 layers) and 1.72e-4
# (rwkv6-7b at 4) in loss and 3.646e-4 / 5.174e-4 in grad norm from the
# unsharded step; the control (``--train-spread``: the unsharded bf16
# step against the unsharded f32 step on the same weights and tokens)
# read 4.467e-3 / 1.452e-2 in loss and 2.511e-4 / 6.124e-4 in grad norm.
# Where a sound reading passes TRAIN_* the step keeps it; zamba2's loss
# and rwkv6's grad norm take a limit between the two readings, so a
# drift the size of bf16's against f32 still fails (the first batch's
# gradients and step 1 keep TRAIN_*)
HYBRID_STEP_LOSS_TOL, SSM_STEP_NORM_TOL = 3.5e-3, 5.6e-4
# [sharded-int8]: Qwen3-4B at full width and depth, 8 sequences decoded
# from an empty 512-slot int8 cache through the sharded decode: 16 prompt
# tokens, then 8 more steps, against the unsharded int8 decode on the
# card under the dense model's LOGIT_TOL / LOGIT_MEDIAN_TOL
SHARDED_INT8_SLOTS, SHARDED_INT8_PROMPT, SHARDED_INT8_STEPS = 512, 16, 8
# the recurrent families' train paths at full width, with phase 8's
# traffic: zamba2-7b with 15 of its 81 Mamba2 layers (two full groups of 6,
# each followed by the shared block, then a remainder of 3: both branches
# of hybrid_groups, and the tied block's gradient summed over two
# applications; 1.605e9 parameters, 25.7 GB of f32 parameters, gradients
# and AdamW moments, where all 81 layers would take 108 GB) and rwkv6-7b
# with 8 of its 32 layers (2.152e9 parameters, 34.4 GB; all 32: 112 GB)
HYBRID_TRAIN_LAYERS, SSM_TRAIN_LAYERS = 15, 8
# [ssm-train]'s one-sequence check: its step launches no kernel, so the
# bf16 pass is held against the f32 pass on the same weights: |d loss|,
# 1 - cosine of the gradients and |gradient norm ratio - 1|. On the H100
# (NVIDIA H100 80GB HBM3, 700 W) the first reading was 1.841e-4,
# 1.809e-4 and 2.710e-4; the limits are about twice that
SSM_TRAIN_LOSS_TOL, SSM_TRAIN_COS_TOL, SSM_TRAIN_NORM_TOL = 4e-4, 4e-4, 6e-4

TABLE1_MOVIELENS = dict(name="movielens-20m", n_rows=138_493, n_cols=27_278,
                        ratings_per_row=144, scale_lo=1, scale_hi=5, K=10,
                        true_rank=8)
# Netflix (Table 1: 480,189 x 17,770, 209 ratings/row, K = 100, the netflix
# preset's true rank 12) with its rows cut to 1/8, on the 8 x 2 grid that
# suggest_grid picks for 16 blocks; see phase_netflix
TABLE1_NETFLIX_CUT = dict(name="netflix-1/8", n_rows=480_189 // 8,
                          n_cols=17_770, ratings_per_row=209, scale_lo=1,
                          scale_hi=5, K=100, true_rank=12)
NETFLIX_BLOCKS = 16

# [serve]: bmf_serve's defaults (k, max_batch 32, max_seen, the 2 ms
# budget) and the router's max_fold, S item slots, 4,096 real-user
# requests per mode and 256 cold starts; check_parity's tolerance
SERVE_K, SERVE_MAX_SEEN, SERVE_FOLD, SERVE_BUDGET_S = 10, 64, 8, 0.002
SERVE_SLOTS, SERVE_REQUESTS, SERVE_COLD = 8, 4096, 256
SERVE_TOL = 1e-5
# [table2]: bench_rmse's methods and configurations on the MovieLens-20M
# shape with its rows cut to 1/8. The baselines pad one CSR of the whole
# matrix to its longest row: at the full shape (longest user row 17,101
# ratings, longest item row 52,041) its planes take 28.4 + 17.0 GB and
# CCD++'s (N, M, K) gather of the users' side 94.7 GB
TABLE2_MOVIELENS_CUT = dict(TABLE1_MOVIELENS, name="movielens-20m-rows/8",
                            n_rows=138_493 // 8)
TABLE2_BLOCKS, TABLE2_SAMPLES, TABLE2_BURNIN = 4, 40, 13
ALS_ITERS, SGD_EPOCHS, CCD_ITERS = 20, 30, 10
# ALS through B1 against its dense path: the same normal equations, the
# per-row sums in another order
ALS_PATH_TOL = 1e-4


T_START = time.time()


def log(*args):
    print(*args, flush=True)


def stamp(done):
    """The run's seconds so far, after the phases named ``done``."""
    log(f"[time] {time.time() - T_START:.1f}s after {done}")


def cuda_ms(fn, reps, warmup=2):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls=20, reps=5):
    """Device milliseconds per call of ``fn``: ``calls`` calls captured in
    one CUDA graph, replayed ``reps`` times between CUDA events (median).
    Unlike ``cuda_ms`` around a single call, the host's time to enqueue a
    call (the wrapper's checks and allocations) does not leave the device
    idle inside the window."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def _roof():
    """``repro_torch.roofline.analysis``: the H100 peaks (NVIDIA data
    sheet, SXM, dense, at the full 700 W power limit) and the roofline
    terms every bound below is computed with."""
    from repro_torch.roofline import analysis
    return analysis


def bound(n_bytes, flops, rate="fp32"):
    """(least ms, "bytes" or "operations") of work moving ``n_bytes`` and
    doing ``flops`` at the ``rate`` precision's peak."""
    return _roof().bound(n_bytes, flops, rate)


def launch_bound(call, n_live):
    """The bound of the one B1 or B2 launch that ``call()`` makes, from
    ``roofline.op_cost`` of its launch record with this call's live slots
    (``n_live``): each live slot's idx, val and mask, the live lengths,
    the factor and (B2) the priors and noise read once, the outputs
    written once; operations as the kernel's plain version counts them,
    B1's Gram kernel above K = 16 on the tensor cores (fp32 factors: 3
    TF32 products each, hi + lo split; bf16: one, exact for the path's
    0/1 masks)."""
    from repro_torch.analysis import optrace as OPT
    from repro_torch.roofline import op_cost as COST
    roof = _roof()
    with OPT.record() as tr:
        call()
    recs = [o for o in tr.ops if o.kernel]
    assert len(recs) == 1, f"expected one launch, got {len(recs)}"
    c = COST.op_cost(recs, live_slots=n_live)
    by_rate = roof.flops_by_rate(c)
    t = roof.RooflineTerms(c["flops"], c["bytes_min"], 0.0, by_rate)
    names = {"fp32": "f32 CUDA-core", "tf32": "3xTF32 products",
             "bf16": "bf16 products"}
    detail = ", ".join([f"bytes {1e3 * t.memory_s:.4f} ms"] + [
        f"{names[k]} {1e3 * f / roof.PEAK_FLOPS[k]:.4f} ms"
        for k, f in by_rate.items() if f])
    return dict(bound_ms=1e3 * t.bound_s, bound_by=t.bound_by,
                bytes=c["bytes_min"], detail=detail)


def phase_build():
    from repro_torch.kernels import build as BUILD
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    t0 = time.time()
    secs = BUILD.build()
    log(f"[build] {time.time() - t0:.1f}s wall; per source: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()))
    for name in BUILD.SOURCES:
        lines = BUILD.lib_path(name).with_suffix(".log").read_text()
        regs = [ln.strip() for ln in lines.splitlines()
                if "registers" in ln or "spill" in ln]
        full = name in SM90 or name in NO_SPILL
        log(f"[build] {name}: " + " | ".join(regs if full else regs[:4]))
        if name == "flash_attention_bwd":
            # by instantiation: at hd 112 each thread holds 14 accumulator
            # columns per row (2 x 14 x 2 in the dk/dv pass)
            log("[build] flash_attention_bwd by kernel: "
                + "; ".join(_ptxas_by_kernel(lines)))
        # the tensor-core kernels keep every accumulator in registers, and
        # the redesigned B2, L3, L4 and L5 their rows, q, partial sums and
        # states
        spills = [ln for ln in regs if "spill" in ln
                  and not ln.startswith("0 bytes stack frame, 0 bytes spill "
                                        "stores, 0 bytes spill loads")]
        if full and spills:
            raise AssertionError(f"{name}: ptxas spills: {spills}")


def _ptxas_by_kernel(log_text):
    """'<kernel><HD>: <registers>; <spills>' per entry function of a ptxas
    -v log whose templates take the head size (the f32 L2's
    ``flash_bwd_{dq,dkv}_kernel<HD>``): ptxas reports each function's
    name, spills and registers in that order."""
    import re
    names, regs, spills = [], [], []
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '\w*?(flash_bwd_\w+?)"
                      r"ILi(\d+)E", ln)
        if m:
            names.append(f"{m.group(1)}<{m.group(2)}>")
        elif "registers" in ln:
            regs.append(re.sub(r".*Used", "Used", ln).split(",")[0])
        elif "spill" in ln:
            spills.append(ln.strip())
    return [f"{n}: {r}; {sp}" for n, r, sp in zip(names, regs, spills)]


def make_data(table=TABLE1_MOVIELENS, n_blocks=64):
    """Table 1 shape ``table`` generated from seed 0, 10% held out, and
    partitioned on the grid ``suggest_grid`` picks for ``n_blocks``."""
    from repro_torch.core.partition import partition, suggest_grid
    from repro_torch.data import synthetic as SYN
    from repro_torch.data.sparse import apply_permutation, train_test_split
    preset = SYN.DatasetPreset(**table)
    t0 = time.time()
    coo, _ = SYN.generate(preset, seed=0)
    train, test = train_test_split(coo, 0.1, seed=1)
    t1 = time.time()
    I, J = suggest_grid(train.n_rows, train.n_cols, n_blocks)
    part = partition(train, I, J)
    t2 = time.time()
    log(f"[data] {preset.name} shape: {train.n_rows} x "
        f"{train.n_cols}, {train.nnz} train / {test.nnz} test ratings, "
        f"K = {preset.K}, grid {I}x{J}; generate+split {t1 - t0:.1f}s, "
        f"partition {t2 - t1:.1f}s")
    test_p = apply_permutation(test, part.row_perm, part.col_perm)
    return preset, train, test, test_p, part


def cut_rows(train, test, part, n):
    """The ratings of the first 1/n of the rows (train and test) and their
    partition on ``part``'s grid."""
    from repro_torch.core.partition import partition
    from repro_torch.data.sparse import COO
    rows = train.n_rows // n

    def cut(c):
        keep = c.row < rows
        return COO(c.row[keep], c.col[keep], c.val[keep], rows, c.n_cols)

    t0 = time.time()
    train_c, test_c = cut(train), cut(test)
    part_c = partition(train_c, part.I, part.J)
    log(f"[data] placement cut: the first 1/{n} of the rows, {rows} x "
        f"{train_c.n_cols}, {train_c.nnz} train / {test_c.nnz} test "
        f"ratings, grid {part.I}x{part.J}; {time.time() - t0:.1f}s")
    return train_c, test_c, part_c


def bucket_planes(part, test_p, K, dev, tag="parity"):
    """The user-side padded CSR planes (B, N, M) of every phase-c block at
    the phase-c bucket, as the stacked executor builds them, their live
    lengths, and the other side's row count D."""
    from repro_torch.core import engine as ENG
    from repro_torch.core import pp as PP
    from repro_torch.data.sparse import row_live
    s = PP.BlockShapes.per_phase(part, test_p)["c"]
    tasks = [t for _, ts in ENG.build_phase_graph(part) for t in ts
             if t.phase == "c"]
    buf = PP.new_block_inputs(s, K, len(tasks), dev, False, False)
    for b, t in enumerate(tasks):
        PP.fill_block_inputs(buf, b, part.block(t.i, t.j), s, test_p)
    idx, val, mask = buf["idx_r"], buf["val_r"], buf["mask_r"]
    del buf
    B, N, M = idx.shape
    live = row_live(mask)
    n_live = int(live.sum())
    n_empty = int((live == 0).sum())
    dead_tiles = int(((M + 31) // 32 - (live + 31) // 32).sum())
    log(f"[{tag}] phase-c bucket: B={B} N={N} M={M} D={s.n_cols} K={K}; "
        f"{n_live} live slots, {n_empty} empty rows, {dead_tiles} "
        f"all-padding 32-slot tiles skipped")
    return idx, val, mask, live, s.n_cols


def b1_parity(idx, val, mask, live, other, tau, tag, plain_reps=3):
    """B1 on the card against its plain version on the same inputs, under
    TOL; both timed with CUDA events (the plain version ``plain_reps``
    times), beside its bound (``launch_bound``)."""
    from repro_torch.kernels.bmf_precision import ops as B1
    from repro_torch.kernels.bmf_precision.ref import precision_accum_plain

    def kern():
        return B1.precision_accum(idx, val, mask, other, tau, live)

    def plain():
        return precision_accum_plain(idx, val, mask, other.float(), tau, live)

    (lam, eta), (lam_p, eta_p) = kern(), plain()
    err = max(float((lam - lam_p).abs().max()),
              float((eta - eta_p).abs().max()))
    scale = max(float(lam_p.abs().max()), float(eta_p.abs().max()), 1.0)
    del lam, eta, lam_p, eta_p
    ms = cuda_ms(kern, 5)
    pms = cuda_ms(plain, plain_reps, warmup=1 if plain_reps > 1 else 0)
    bnd = launch_bound(kern, int(live.sum()))
    tol = TOL["bmf_precision"]
    ok = err <= tol * scale
    tb = bnd["bytes"] / ms / 1e9
    dtype = "bf16" if other.element_size() == 2 else "fp32"
    log(f"[{tag}] bmf_precision {dtype}: max_abs_err {err:.3e} (tolerance {tol:.0e} x {scale:.3g} "
        f"= {tol * scale:.3e}) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms "
        f"({tb:.3f} TB/s), plain {pms:.3f} ms, bound {bnd['bound_ms']:.4f} "
        f"ms ({bnd['bound_by']}; {bnd['detail']})")
    if not ok:
        raise AssertionError(f"{tag}: bmf_precision {dtype} disagrees with "
                             f"its plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms,
                bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                tb_per_s=tb)


def phase_parity(part, test_p, K, dev):
    """B1 and B2 against their plain versions at the phase-c bucket."""
    import torch
    from repro_torch.kernels.bmf_sweep import ops as B2
    from repro_torch.kernels.bmf_sweep.ref import sweep_ref_padded

    idx, val, mask, live, D = bucket_planes(part, test_p, K, dev)
    B, N, M = idx.shape
    L = int(live.sum())
    assert int((live == 0).sum()) > 0
    assert int(((M + 31) // 32 - (live + 31) // 32).sum()) > 0

    g = torch.Generator(device=dev).manual_seed(0)
    other32 = torch.randn((B, D, K), generator=g, device=dev) / K ** 0.5
    A = torch.randn((B, N, K, K), generator=g, device=dev) * 0.2
    prior_lam = (A @ A.mT + 1.5 * torch.eye(K, device=dev)).contiguous()
    del A
    prior_eta = torch.randn((B, N, K), generator=g, device=dev) * 0.3
    z = torch.randn((B, N, K), generator=g, device=dev)
    tau = 2.0
    results = {}
    for dtype in ("fp32", "bf16"):
        other = other32.to(torch.bfloat16) if dtype == "bf16" else other32
        results[("bmf_precision", dtype)] = b1_parity(
            idx, val, mask, live, other, tau, "parity")

        def b2():
            return B2.fused_sweep(z, idx, val, mask, prior_eta, prior_lam,
                                  other, tau, dtype=dtype, live=live)

        def b2_plain():
            return sweep_ref_padded(idx, val, mask, prior_eta, prior_lam, z,
                                    other, tau, live=live)

        U, U_p = b2(), b2_plain()
        assert bool(torch.isfinite(U).all())
        err = float((U - U_p).abs().max())
        sc = max(float(U_p.abs().max()), 1.0)
        del U, U_p
        ms, pms = cuda_ms(b2, 5), cuda_ms(b2_plain, 3, warmup=1)
        bnd = launch_bound(b2, L)
        n_bytes, bd = bnd["bytes"], (bnd["bound_ms"], bnd["bound_by"])
        ok = err <= TOL["bmf_sweep"] * sc
        log(f"[parity] bmf_sweep {dtype}: max_abs_err {err:.3e} (tolerance "
            f"{TOL['bmf_sweep']:.0e} x {sc:.3g} = {TOL['bmf_sweep'] * sc:.3e}"
            f") {'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms "
            f"({n_bytes / ms / 1e9:.3f} TB/s), plain {pms:.3f} ms, bound "
            f"{bd[0]:.3f} ms ({bd[1]})")
        if not ok:
            raise AssertionError(f"bmf_sweep {dtype} disagrees with its "
                                 f"plain version")
        results[("bmf_sweep", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bd[0],
            bound_by=bd[1], tb_per_s=n_bytes / ms / 1e9)
    del idx, val, mask, live, other32, prior_lam, prior_eta, z
    torch.cuda.empty_cache()
    return results


def _wrappers():
    from repro_torch.kernels.bmf_precision import ops as B1
    from repro_torch.kernels.bmf_sweep import ops as B2
    from repro_torch.kernels.decode_attention import ops as L3
    from repro_torch.kernels.flash_attention import ops as L1
    from repro_torch.kernels.ssd_chunk import ops as L4
    from repro_torch.kernels.wkv6 import ops as L5
    return {"bmf_precision": B1.precision_accum, "bmf_sweep": B2.fused_sweep,
            "flash_attention": L1.flash_attention,
            "flash_attention_bwd": L1.flash_bwd,
            "decode_attention": L3.decode_attention,
            "ssd_chunk": L4.ssd_scan, "wkv6": L5.wkv6}


# L1 and L2 count their bf16 launches (the sm90 tensor-core kernels)
# beside their totals; f32 calls go to the f32 kernels
SM90 = {"flash_attention_sm90": "flash_attention",
        "flash_attention_bwd_sm90": "flash_attention_bwd"}
# sources whose ptxas report must show no spill besides the sm90 ones: B1
# and B2 (a row's Λ in one thread's registers; B1's Gram accumulators), the
# 3xTF32 L1 and L2 (q fragments, dq / dk / dv in mma accumulators), the
# pipelined split-KV L3 and the tensor-core L4 and L5
NO_SPILL = ("bmf_precision", "bmf_sweep", "flash_attention",
            "flash_attention_bwd", "decode_attention", "ssd_chunk", "wkv6")


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "sm90_launches"):
            fn.sm90_launches = 0


def read_counts():
    fns = _wrappers()
    counts = {name: fn.launches for name, fn in fns.items()}
    counts.update({v: fns[name].sm90_launches for v, name in SM90.items()})
    return counts


def mean_rmse(train, test):
    import numpy as np
    return float(np.sqrt(np.mean((test.val - train.val.mean()) ** 2)))


def phase_quickstart(dev):
    from repro_torch.core import bmf as BMF
    from repro_torch.core import pp as PP
    from repro_torch.core.partition import partition
    from repro_torch.data import synthetic as SYN
    from repro_torch.data.sparse import train_test_split
    coo, preset = SYN.generate("mini", seed=0)
    train, test = train_test_split(coo, test_frac=0.15, seed=1)
    cfg = BMF.BMFConfig(K=preset.K, n_samples=50, burnin=20,
                        sweep_fused=True)
    reset_counts()
    rmse_bmf, secs, _ = PP.run_full_bmf(0, train, test, cfg, device=dev)
    res = PP.run_pp(1, partition(train, 2, 2), cfg, test,
                    executor="stacked", device=dev)
    counts = read_counts()
    base = mean_rmse(train, test)
    log(f"[quickstart] mean predictor {base:.4f}; full BMF {rmse_bmf:.4f} "
        f"({secs:.2f}s); PP 2x2 stacked {res.rmse:.4f} "
        f"({res.wall_time_s:.2f}s); launches {counts}")
    assert res.rmse < base, "PP must beat the mean predictor"
    assert counts["bmf_sweep"] > 0
    return counts


def phase_main(train, test, part, cfg, label, kernel, dev, executor=None):
    """One ``run_pp`` of the main path through ``executor`` (default: a
    stacked executor): RMSE below the mean predictor, the kernel
    launched, no health-guard fault, peak device memory below 80 GB.
    Returns (launch counts, result, peak bytes)."""
    import numpy as np
    import torch
    from repro_torch.core import engine as ENG
    from repro_torch.core import pp as PP
    ex = ENG.StackedExecutor() if executor is None else executor
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = PP.run_pp(0, part, cfg, test, executor=ex, device=dev)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    base = mean_rmse(train, test)
    chain = ex.timings["chain_s"]
    # the overlapped executors run padding and chains side by side: pad is
    # the host's padding time, chains the first dispatch to last resolve
    extra = ""
    if isinstance(ex, ENG.StreamingExecutor):
        shapes = {id(s): s for s in ex.window_shapes.values()}.values()
        blk = max(s.block_bytes(cfg.K) for s in shapes)
        groups = ex.topology.block if ex.topology is not None else 1
        extra = (f"; window {ex.window} depth {ex.depth}: "
                 f"peak_window_blocks {ex.peak_window_blocks} (bound "
                 f"{groups * ex.window * (ex.depth + 1)}), x block_bytes "
                 f"{blk / 2**20:.1f} MiB = "
                 f"{ex.peak_window_blocks * blk / 2**30:.2f} GiB; window "
                 f"slots {ex.window_bytes / 2**30:.2f} GiB")
    log(f"[main:{label}] RMSE {res.rmse:.4f} (mean "
        f"predictor {base:.4f}); wall {res.wall_time_s:.2f}s, phases "
        + ", ".join(f"{k} {v:.2f}s" for k, v in res.phase_times_s.items())
        + f"; pad {ex.timings['pad_s']:.2f}s, chains {chain:.2f}s; "
        f"ratings/s {train.nnz * cfg.n_samples / chain:.4g} over the chains, "
        f"{train.nnz * cfg.n_samples / res.wall_time_s:.4g} over the wall; "
        f"peak device memory {peak / 2**30:.2f} GiB; launches {counts}"
        + extra)
    assert np.isfinite(res.rmse) and res.rmse < base, \
        f"{label}: RMSE {res.rmse} does not beat the mean predictor {base}"
    assert counts[kernel] > 0, f"{label}: {kernel} was never launched"
    assert not res.faults, f"{label}: health-guard faults {res.faults}"
    assert peak < 80e9, f"{label}: peak device memory {peak / 1e9:.1f} GB"
    return counts, res, peak


def same_rmse(label, res, ref, ref_label):
    """An overlapped run against the stacked run of the same data and
    config: RMSE within PP_RMSE_TOL."""
    gap = abs(res.rmse - ref.rmse)
    log(f"[{label}] RMSE {res.rmse:.6f} vs {ref_label} {ref.rmse:.6f}: "
        f"|gap| {gap:.3e} (limit {PP_RMSE_TOL:.0e}) "
        f"{'ok' if gap <= PP_RMSE_TOL else 'FAIL'}")
    assert gap <= PP_RMSE_TOL, f"{label}: RMSE {gap:.3e} from {ref_label}"


def phase_overlapped(train, test, part, cfg, ref, ref_peak, dev):
    """The main path through the async executor and the streaming
    executor (W = 4, depth 2), each held to the stacked run ``ref``
    (peak device memory ``ref_peak``). Returns their B2 launch counts."""
    from repro_torch.core import engine as ENG
    launches = {}
    for label, ex in (("async", ENG.AsyncExecutor()),
                      ("streaming", ENG.StreamingExecutor(window=4,
                                                          depth=2))):
        counts, res, peak = phase_main(train, test, part, cfg, label,
                                       "bmf_sweep", dev, executor=ex)
        same_rmse(f"main:{label}", res, ref, "stacked")
        log(f"[main:{label}] peak device memory {peak / 2**30:.2f} GiB "
            f"beside the stacked run's {ref_peak / 2**30:.2f} GiB")
        if label == "streaming":
            bound = ex.window * (ex.depth + 1)
            assert ex.peak_window_blocks <= bound, \
                f"peak_window_blocks {ex.peak_window_blocks} > {bound}"
        launches[label] = counts["bmf_sweep"]
    return launches


def _topology(shape):
    from repro_torch.core.topology import Topology
    return Topology(*shape)


def phase_groups(train, test, part, cfg, ref, ref_peak, dev):
    """The main path on device groups of the one card: async on
    ``Topology(4, 1)`` (4 streams) and streaming on ``Topology(2, 1)``
    (W = 4 per group, depth 2), each held to the stacked run ``ref``.
    Returns their B2 launch counts and the async result."""
    from repro_torch.core import engine as ENG
    launches, out = {}, None
    for label, ex in (
            ("async-groups", ENG.AsyncExecutor(
                topology=_topology(ASYNC_GROUPS))),
            ("streaming-groups", ENG.StreamingExecutor(
                window=4, depth=2, topology=_topology(STREAM_GROUPS)))):
        counts, res, peak = phase_main(train, test, part, cfg, label,
                                       "bmf_sweep", dev, executor=ex)
        same_rmse(f"main:{label}", res, ref, "stacked")
        log(f"[main:{label}] {ex.topology.describe()}; wall "
            f"{res.wall_time_s:.2f}s, pad {ex.timings['pad_s']:.2f}s, chains "
            f"{ex.timings['chain_s']:.2f}s"
            f"; peak device memory {peak / 2**30:.2f} GiB beside the "
            f"stacked run's {ref_peak / 2**30:.2f} GiB")
        if label == "streaming-groups":
            bound = STREAM_GROUPS[0] * ex.window * (ex.depth + 1)
            assert ex.peak_window_blocks <= bound
        else:
            out = res
        launches[label] = counts["bmf_sweep"]
    return launches, out


def csrt_bytes(part, test, S, G, scatter):
    """Device bytes of the 'psum'/'scatter' transposed shard planes
    (B, S, D_pad, M_c) int32 + 2 x f32 per bucket, B padded to G groups:
    (largest bucket, all buckets)."""
    from repro_torch.core import engine as ENG
    from repro_torch.core import pp as PP
    from repro_torch.data.sparse import apply_permutation
    shapes = PP.BlockShapes.per_phase(
        part, apply_permutation(test, part.row_perm, part.col_perm))
    per = []
    for tag, s in shapes.items():
        n = sum(1 for _, ts in ENG.build_phase_graph(part) for t in ts
                if t.phase == tag)
        B = -(-n // G) * G
        D_pad = -(-s.n_cols // S) * S if scatter else s.n_cols
        per.append(12 * B * D_pad * (-(-s.m_cols // 8) * 8))
    return max(per), sum(per)


def phase_sharded(train, test, part, cfg, ref, ref_peak, dev):
    """The sharded executor on ``Topology(2, 2)`` of the one card, in the
    'gather', 'psum' and 'scatter' modes: 'gather' within PP_RMSE_TOL of
    the stacked run, 'psum' within PSUM_RMSE_TOL, 'scatter' below the
    mean predictor and within SCATTER_RMSE_TOL. Returns the B1 and B2
    launches by mode."""
    import numpy as np
    from repro_torch.core import distributed as DIST
    from repro_torch.core import engine as ENG
    from repro_torch.core import pp as PP
    from repro_torch.data.sparse import apply_permutation
    topo = _topology(SHARDED)
    G, S = topo.block, topo.data
    s = PP.BlockShapes.per_phase(
        part, apply_permutation(test, part.row_perm, part.col_perm))["c"]
    N, D, K = s.n_rows, s.n_cols, cfg.K
    base = mean_rmse(train, test)
    b1, b2 = {}, {}
    for comm, tol in (("gather", PP_RMSE_TOL), ("psum", PSUM_RMSE_TOL),
                      ("scatter", SCATTER_RMSE_TOL)):
        label = f"sharded-{comm}"
        comm_b = 4 * N * K + (0 if comm == "gather" else
                              DIST.sweep_comm_bytes(D, K) if comm == "psum"
                              else DIST.sweep_comm_bytes_scatter(D, K))
        if comm != "gather":
            big, total = csrt_bytes(part, test, S, G, comm == "scatter")
            log(f"[main:sharded] {comm}: transposed shard planes "
                f"{big / 2**30:.2f} GiB in the largest bucket "
                f"({total / 2**30:.2f} GiB over all buckets), beside the "
                f"stacked run's {ref_peak / 2**30:.2f} GiB peak")
        ex = ENG.ShardedExecutor(topology=topo, comm=comm)
        counts, res, peak = phase_main(train, test, part, cfg, label,
                                       "bmf_sweep", dev, executor=ex)
        gap = abs(res.rmse - ref.rmse)
        ok = gap <= tol and (comm != "scatter" or res.rmse < base)
        log(f"[main:sharded] {comm} on {topo.describe()}: RMSE "
            f"{res.rmse:.6f} vs stacked {ref.rmse:.6f}, |gap| {gap:.3e} "
            f"(limit {tol:g}"
            f"{', and below the mean predictor ' + format(base, '.4f') if comm == 'scatter' else ''}) "
            f"{'ok' if ok else 'FAIL'}; {comm_b} bytes per phase-c "
            f"block-sweep would cross slots on separate cards (one card "
            f"here: on-device tensor ops; peer copies unverified); wall "
            f"{res.wall_time_s:.2f}s, pad {ex.timings['pad_s']:.2f}s, "
            f"chains {ex.timings['chain_s']:.2f}s, peak device memory "
            f"{peak / 2**30:.2f} GiB; B1 {counts['bmf_precision']}, B2 "
            f"{counts['bmf_sweep']} launches")
        assert ok, f"{label}: RMSE {res.rmse} against stacked {ref.rmse}"
        assert np.isfinite(res.rmse)
        if comm != "gather":
            assert counts["bmf_precision"] > 0, \
                f"{label}: B1 never launched in the V-step"
        b1[label], b2[label] = counts["bmf_precision"], counts["bmf_sweep"]
    return b1, b2


def phase_group_faults(train, test, part, cfg, clean, dev):
    """The group fault domain on ``Topology(4, 1)`` of the one card: group
    1 dead from its first dispatch (quarantine_after = 1) heals bitwise to
    the clean grouped run ``clean`` with one quarantine; group 1 slowed by
    GROUP_SLOW_S under GROUP_SPECULATE_AT resolves every block exactly once,
    twice over to the same numbers."""
    import collections
    import torch
    from repro_torch.core import engine as ENG
    from repro_torch.core import pp as PP

    def same(a, b):
        return (a.rmse == b.rmse
                and all(torch.equal(x, y) for x, y in (
                    (a.U_agg.eta, b.U_agg.eta),
                    (a.U_agg.Lambda, b.U_agg.Lambda),
                    (a.V_agg.eta, b.V_agg.eta),
                    (a.V_agg.Lambda, b.V_agg.Lambda))))

    def graph_resolves(ex):
        n = collections.Counter(c for ev, c, *_ in ex.trace
                                if ev == "resolve")
        return set(n) == {(i, j) for i in range(part.I)
                          for j in range(part.J)} and set(n.values()) == {1}

    ex = ENG.AsyncExecutor(topology=_topology(ASYNC_GROUPS),
                           record_trace=True)
    t0 = time.time()
    res = PP.run_pp(0, part, cfg, test, executor=ex, device=dev,
                    fault_plan=ENG.FaultPlan(group_dead_at={1: 0}),
                    fault_policy=ENG.FaultPolicy(
                        timeout_floor_s=GROUP_FLOOR_S, quarantine_after=1))
    ok = (same(res, clean) and res.group_stats["n_quarantined"] == 1
          and graph_resolves(ex))
    log(f"[group-faults] dead group 1 (quarantine_after 1, floor "
        f"{GROUP_FLOOR_S:.0f}s): {time.time() - t0:.2f}s, "
        f"{res.group_stats}, faults "
        f"{sorted({(f.kind, f.action) for f in res.faults})}; bitwise the "
        f"clean grouped run and one resolve per block: "
        f"{'ok' if ok else 'FAIL'}")
    assert ok, "[group-faults] the quarantined run departs"
    runs = []
    for rep in range(2):
        ex = ENG.AsyncExecutor(topology=_topology(ASYNC_GROUPS),
                               record_trace=True)
        t0 = time.time()
        r = PP.run_pp(0, part, cfg, test, executor=ex, device=dev,
                      fault_plan=ENG.FaultPlan(
                          group_slow_at={1: (0, GROUP_SLOW_S)}),
                      fault_policy=ENG.FaultPolicy(
                          timeout_floor_s=60.0,
                          speculate_at=GROUP_SPECULATE_AT))
        ok = graph_resolves(ex) and r.group_stats["n_speculations"] >= 1
        log(f"[group-faults] slow group 1 ({GROUP_SLOW_S:.1f}s, speculate_at "
            f"{GROUP_SPECULATE_AT}), run {rep + 1}: {time.time() - t0:.2f}s, "
            f"{r.group_stats}; "
            f"one resolve per block: {'ok' if ok else 'FAIL'}")
        assert ok, "[group-faults] speculation resolved a block twice or never"
        runs.append(r)
    ok = same(runs[0], runs[1]) and same(runs[0], clean)
    log(f"[group-faults] the two speculating runs and the clean grouped run "
        f"are bitwise equal: {'ok' if ok else 'FAIL'}")
    assert ok, "[group-faults] speculation changed the numbers"


def phase_bmf_sync(part, test, cfg, dev):
    """One async block dispatch (a phase-c block, both priors propagated)
    and one ``_aggregate_axis`` under ``analysis.guards.no_host_transfers``
    (``torch.cuda.set_sync_debug_mode("error")``): either raising fails
    the smoke. The blocks it depends on are dispatched first, unchecked
    (they also pay the first call's lazy initialisation)."""
    import torch
    from repro_torch.analysis import guards
    from repro_torch.core import engine as ENG
    from repro_torch.core import pp as PP
    from repro_torch.data.sparse import apply_permutation
    test_p = apply_permutation(test, part.row_perm, part.col_perm)
    ctx = ENG.PhaseContext(part=part, cfg=cfg, test_p=test_p, seed=0,
                           shapes=PP.BlockShapes.per_phase(part, test_p),
                           device=dev)
    tasks = {t.coord: t for _, ts in ENG.build_phase_graph(part) for t in ts}
    ex = ENG.AsyncExecutor()
    ex._reset_run_state()
    for c in ((0, 0), (1, 0), (0, 1)):
        ex._dispatch(ctx, tasks[c])
    torch.cuda.synchronize()
    with guards.no_host_transfers():
        _, _, out = ex._dispatch(ctx, tasks[(1, 1)])
        posts = [[out.U_post] * part.J for _ in range(part.I)]
        PP._aggregate_axis(part, posts, axis="row")
    torch.cuda.synchronize()
    log("[bmf-sync] one async dispatch of block (1, 1) and one "
        "_aggregate_axis ran under set_sync_debug_mode('error'): no "
        "synchronizing call")


# [dryrun]: sweeps of the bucket chain planned and run (one burn-in, one
# kept), and how far the planned peak may sit from the card's
DRYRUN_SWEEPS = 2
DRYRUN_PEAK_TOL = 0.25


def bucket_inputs(part, test_p, K, dev):
    """The phase-c bucket's stacked chain inputs on the card, as the
    stacked executor pads them (``pp.new_block_inputs`` /
    ``fill_block_inputs``), with N(0, I) propagated priors: (planes both
    ways, test ids, priors, the bucket's shapes)."""
    from repro_torch.core import engine as ENG
    from repro_torch.core import pp as PP
    from repro_torch.core.posterior import RowGaussians
    from repro_torch.data.sparse import PaddedCSR
    s = PP.BlockShapes.per_phase(part, test_p)["c"]
    tasks = [t for _, ts in ENG.build_phase_graph(part) for t in ts
             if t.phase == "c"]
    buf = PP.new_block_inputs(s, K, len(tasks), dev, True, True)
    for b, t in enumerate(tasks):
        PP.fill_block_inputs(buf, b, part.block(t.i, t.j), s, test_p)
    for side in ("up", "vp"):
        buf[side + "_lam"].diagonal(dim1=-2, dim2=-1).fill_(1.0)
    rows = PaddedCSR(buf["idx_r"], buf["val_r"], buf["mask_r"],
                     n_cols=s.n_cols)
    cols = PaddedCSR(buf["idx_c"], buf["val_c"], buf["mask_c"],
                     n_cols=s.n_rows)
    return (rows, cols, buf["tr"], buf["tc"],
            RowGaussians(buf["up_eta"], buf["up_lam"]),
            RowGaussians(buf["vp_eta"], buf["vp_lam"]), s)


def phase_dryrun(part, test_p, cfg, dev, tag):
    """``[dryrun]``: one phase-c bucket's stacked chain planned on
    ``meta`` (``launch.bmf_dryrun.trace_bucket``: ``DRYRUN_SWEEPS`` sweeps,
    nothing allocated), then run on the card on the bucket's real planes.
    Planned against measured: peak bytes (the chain's inputs plus its
    high-water mark, against ``max_memory_allocated`` over the run less
    what else the card holds), within DRYRUN_PEAK_TOL or the run fails;
    B1 and B2 launches, equal or the run fails; and each launch's
    roofline time (the plan's, every padded slot; and with this run's
    live slots) beside the kernel's measured time on the same planes."""
    import torch
    from repro_torch.analysis import optrace as OPT
    from repro_torch.core import gibbs as GIBBS
    from repro_torch.data.sparse import row_live
    from repro_torch.kernels.bmf_precision import ops as B1
    from repro_torch.kernels.bmf_sweep import ops as B2
    from repro_torch.launch import bmf_dryrun as DRY
    from repro_torch.roofline import op_cost as COST
    roof = _roof()
    rows, cols, tr, tc, up, vp, s = bucket_inputs(part, test_p, cfg.K, dev)
    B, N, M = rows.idx.shape
    D, M_c = cols.idx.shape[1:]
    run_cfg = cfg._replace(n_samples=DRYRUN_SWEEPS,
                           burnin=DRYRUN_SWEEPS - 1, phase_bc_samples=None)
    t0 = time.time()
    plan = DRY.trace_bucket(cfg, B, N, D, M, M_c, sweeps=DRYRUN_SWEEPS,
                            device="meta", n_test=s.n_test)
    plan_s = time.time() - t0
    planned = OPT.kernel_counts(plan.ops)
    inputs = [rows.idx, rows.val, rows.mask, cols.idx, cols.val, cols.mask,
              tr, tc, up.eta, up.Lambda, vp.eta, vp.Lambda]
    in_bytes = COST.storage_bytes(inputs)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - in_bytes
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = GIBBS.run_gibbs_stacked(list(range(B)), rows, cols, tr, tc,
                                  run_cfg, up, vp, device=dev)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - held
    counts = read_counts()
    del res
    torch.cuda.empty_cache()
    gap = plan.peak_bytes / measured - 1
    log(f"[dryrun] {tag} bucket B={B} N={N} M={M} D={D} M_c={M_c} "
        f"K={cfg.K} ({'B2' if cfg.sweep_fused else 'B1 + torch Cholesky'}), "
        f"{DRYRUN_SWEEPS} sweeps: planned on meta in {plan_s:.2f}s; peak "
        f"planned {plan.peak_bytes / 2**30:.3f} GiB vs measured "
        f"{measured / 2**30:.3f} GiB (gap {100 * gap:+.1f}%, limit "
        f"{100 * DRYRUN_PEAK_TOL:.0f}%; inputs {in_bytes / 2**30:.3f} "
        f"GiB); launches planned {planned} vs counted "
        f"{ {k: v for k, v in counts.items() if v} }")
    for name in ("bmf_precision", "bmf_sweep"):
        want = planned.get(f"repro_torch::{name}", 0)
        assert counts[name] == want, (
            f"[dryrun] {tag}: {name} planned {want}, counted {counts[name]}")
    assert abs(gap) <= DRYRUN_PEAK_TOL, (
        f"[dryrun] {tag}: planned peak {plan.peak_bytes} vs measured "
        f"{measured}")
    # each side's launch: its roofline on the plan (every slot) and with
    # this run's live slots, beside the kernel's time on these planes
    g = torch.Generator(device=dev).manual_seed(0)
    recs = [o for o in plan.ops if o.kernel]
    for side, csr, n_other, prior in (("U", rows, D, up), ("V", cols, N, vp)):
        rec = next(o for o in recs if o.operands[0].shape == csr.idx.shape)
        live = row_live(csr.mask)
        n_live = int(live.sum())
        other = torch.randn((B, n_other, cfg.K), generator=g, device=dev)
        z = torch.randn(prior.eta.shape, generator=g, device=dev)
        if cfg.sweep_fused and cfg.K <= B2.SWEEP_K_MAX:

            def call():
                return B2.fused_sweep(z, csr.idx, csr.val, csr.mask,
                                      prior.eta, prior.Lambda, other, 2.0,
                                      live=live)
        else:

            def call():
                return B1.precision_accum(csr.idx, csr.val, csr.mask, other,
                                          2.0, live)
        terms = {}
        for label, slots in (("plan", None), ("live", n_live)):
            c = COST.kernel_cost(rec, slots)
            terms[label] = roof.RooflineTerms(
                c["flops"], c["bytes_min"], 0.0, roof.flops_by_rate(c))
        ms = cuda_ms(call, 5)
        log(f"[dryrun] {tag} {rec.op.split('::')[1]} {side}-side: roofline "
            f"{1e3 * terms['plan'].bound_s:.4f} ms planned (every slot, "
            f"{terms['plan'].bound_by}), "
            f"{1e3 * terms['live'].bound_s:.4f} ms at this run's {n_live} "
            f"live slots ({terms['live'].bound_by}); measured {ms:.4f} ms "
            f"({ms / (1e3 * terms['live'].bound_s):.2f}x the live bound)")
        del other, z, live
    del rows, cols, tr, tc, up, vp
    torch.cuda.empty_cache()
    return {k: v for k, v in counts.items() if v}


def phase_dryrun_cli():
    """``[dryrun]``: ``bmf_dryrun --pp-engine`` at the reference's defaults
    (the Netflix shape, 256 shards, K = 100) on ``meta``: its seconds and
    each record's dominant term and planned peak."""
    from repro_torch.launch import bmf_dryrun as DRY
    t0 = time.time()
    recs = DRY.run(DRY.parser().parse_args(["--pp-engine"]))
    secs = time.time() - t0
    for rec in recs:
        log(f"[dryrun] {DRY.describe(rec)}")
    assert len(recs) == 7
    log(f"[dryrun] bmf_dryrun --pp-engine on meta: {secs:.1f}s, "
        f"{len(recs)} records; dominant terms "
        + ", ".join(f"{r['variant']}"
                    f"{'[' + r['comm'] + ']' if 'comm' in r else ''} "
                    f"{r['roofline']['dominant']}"
                    for r in recs if "roofline" in r))


def phase_netflix(dev):
    """The paper's K = 100 shape (docstring, phase 4): B1 at the run's
    phase-c bucket against its plain version, then the use-kernel run,
    stacked and streaming. Returns B1's two parity cases and its launches
    in the two runs."""
    import torch
    from repro_torch.core import bmf as BMF
    from repro_torch.core import engine as ENG
    preset, train, test, test_p, part = make_data(TABLE1_NETFLIX_CUT,
                                                  NETFLIX_BLOCKS)
    K = preset.K
    idx, val, mask, live, D = bucket_planes(part, test_p, K, dev,
                                            tag="netflix-parity")
    g = torch.Generator(device=dev).manual_seed(0)
    other32 = torch.randn((idx.shape[0], D, K), generator=g,
                          device=dev) / K ** 0.5
    cases = []
    for dtype in ("fp32", "bf16"):
        other = other32.to(torch.bfloat16) if dtype == "bf16" else other32
        cases.append(dict(case="netflix-k100-phase-c", dtype=dtype,
                          **b1_parity(idx, val, mask, live, other, 2.0,
                                      "netflix-parity", plain_reps=1)))
    del idx, val, mask, live, other32, other
    torch.cuda.empty_cache()
    cfg = BMF.BMFConfig(K=K, n_samples=SAMPLES, burnin=BURNIN,
                        use_kernel=True)
    phase_dryrun(part, test_p, cfg, dev, "netflix-k100")
    counts, ref, peak = phase_main(train, test, part, cfg, "netflix-k100",
                                   "bmf_precision", dev)
    # the same cut through the streaming executor: W = 2 blocks a chunk
    ex = ENG.StreamingExecutor(window=2, depth=2)
    s_counts, res, s_peak = phase_main(train, test, part, cfg,
                                       "netflix-streaming", "bmf_precision",
                                       dev, executor=ex)
    same_rmse("netflix-streaming", res, ref, "stacked")
    bound = ex.window * (ex.depth + 1)
    log(f"[netflix-streaming] peak device memory {s_peak / 2**30:.2f} GiB "
        f"beside the stacked run's {peak / 2**30:.2f} GiB; "
        f"peak_window_blocks {ex.peak_window_blocks} (bound {bound})")
    assert ex.peak_window_blocks <= bound
    del train, test, test_p, part
    torch.cuda.empty_cache()
    return cases, counts["bmf_precision"], s_counts["bmf_precision"]


def cold_requests(train, n, seed):
    """``n`` cold-start requests (user_id = -1), each folding in the first
    SERVE_FOLD training ratings of a real user, those items seen."""
    import numpy as np
    from repro_torch.launch.bmf_serve import user_ratings
    from repro_torch.serving import Request
    users, starts, items, vals = user_ratings(train)
    ok = np.flatnonzero(np.diff(starts) >= SERVE_FOLD)
    rng = np.random.default_rng(seed)
    out = []
    for i in rng.choice(ok, size=n, replace=False):
        lo = starts[i]
        its = [int(c) for c in items[lo:lo + SERVE_FOLD]]
        out.append(Request(user_id=-1, seen=its, fold_items=its,
                           fold_ratings=[float(v) for v in
                                         vals[lo:lo + SERVE_FOLD]]))
    return out


def brute_force_check(store, reqs, tickets, k, jitter=1e-6):
    """Every mean-mode answer against a dense top-k over the store means,
    computed independently in float64 on the host (a cold start's mean
    from its folded ratings): each served item's score must reach the
    k-th best within SERVE_TOL, and the count of valid ids must be
    min(k, unseen items). Returns the largest |served f32 score - float64
    score| and the largest |float64 score| served."""
    import numpy as np
    U = store.U_mean.double().cpu().numpy()
    V = store.V_mean.double().cpu().numpy()
    tau = float(store.tau)
    K = V.shape[1]
    gap = top = 0.0
    for lo in range(0, len(reqs), 256):
        part = list(zip(reqs[lo:lo + 256], tickets[lo:lo + 256]))
        mu = np.empty((len(part), K))
        for i, (r, _) in enumerate(part):
            if r.user_id >= 0:
                mu[i] = U[r.user_id]
                continue
            v = V[np.asarray(r.fold_items, int)]
            lam = (1.0 + jitter) * np.eye(K) + tau * v.T @ v
            mu[i] = np.linalg.solve(
                lam, tau * v.T @ np.asarray(r.fold_ratings, np.float64))
        scores = mu @ V.T
        for i, (r, t) in enumerate(part):
            s = scores[i]
            s[np.asarray(r.seen, int)] = -np.inf
            kth = -np.partition(-s, k - 1)[k - 1]
            served = s[t.ids[t.valid]]
            want = min(k, int(np.isfinite(s).sum()))
            if served.size != want or not (served >= kth - SERVE_TOL).all():
                raise AssertionError(
                    f"[serve] request {lo + i} (user {r.user_id}): served "
                    f"{t.ids[t.valid]} scores {served}, k-th best {kth}")
            gap = max(gap, float(np.abs(t.scores[t.valid] - served).max()))
            top = max(top, float(np.abs(served).max()))
    return gap, top


def _serve_run(router, reqs):
    """Serve ``reqs`` through ``router`` on the wall clock after one
    warm-up batch: (tickets, wall seconds, latencies, dispatches)."""
    for r in reqs[:router.max_batch]:
        router.submit(r)
    router.flush()
    router.latencies_s.clear()
    router.dispatches.clear()
    t0 = time.time()
    tickets = []
    for r in reqs:
        tickets.append(router.submit(r))
        router.poll()
    router.flush()
    return tickets, time.time() - t0


def _serve_profile(router, reqs, n=512):
    """``n`` requests through ``router`` under ``torch.profiler``: the
    device's busy share of the wall and its top kernels."""
    import torch
    torch.cuda.synchronize()
    with device_profile() as prof:
        t0 = time.time()
        for r in reqs[:n]:
            router.submit(r)
        router.flush()
        wall = time.time() - t0
    kernels, busy = device_time(prof)
    if not kernels:
        log("[serve-profile] the profiler recorded no device time: busy "
            "share not measured")
        return
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]
    log(f"[serve-profile] {n} requests, {router.mode}: profiled wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / (1e3 * wall):.1f}% of the wall), "
        f"{sum(c for _, c in kernels.values())} device activities; top: "
        + "; ".join(f"{k[:50]} {us / 1e3:.2f} ms x{c}"
                    for k, (us, c) in top))


def indefinite_rows(lam):
    """Rows of (N, K, K) precisions whose symmetric part is not positive
    definite (smallest eigenvalue <= 0), counted in EIGH_ROWS chunks."""
    import torch
    from repro_torch.serving.store import EIGH_ROWS
    n = 0
    for lo in range(0, lam.shape[0], EIGH_ROWS):
        x = lam[lo:lo + EIGH_ROWS]
        n += int((torch.linalg.eigvalsh((x + x.mT) / 2)[:, 0] <= 0).sum())
    return n


def phase_bmf_serve(train, test, res, dev):
    """BMF serving at the MovieLens-20M shape from phase 4's stacked
    fused-sweep result (docstring, phase 4): the store, SERVE_REQUESTS
    real-user requests per mode through a ``MicroBatchRouter`` with
    ``bmf_serve``'s defaults, SERVE_COLD cold-start fold-ins, each mean
    answer against a float64 brute force, the Thompson answers' validity,
    and one warm scoring call per mode under
    ``analysis.guards.no_host_transfers``."""
    import numpy as np
    import torch
    from repro_torch.analysis import guards
    from repro_torch.launch import bmf_serve as SERVE
    from repro_torch.serving import MicroBatchRouter, PosteriorStore
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    store = PosteriorStore.from_pp_result(res, seed=2, n_slots=SERVE_SLOTS)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in
                  (*store.U, *store.V, store.U_mean, store.V_mean,
                   store.V_samples))
    log(f"[serve] store: {store.n_users} users x {store.n_items} items, "
        f"K = {store.K}, {store.n_slots} slots: built in {build_s:.3f}s, "
        f"{n_bytes / 2**20:.1f} MiB")
    # the aggregates behind the store (ROADMAP C): the test RMSE of its
    # posterior-mean scores, and the rows the PD projection had to repair
    rows = torch.from_numpy(test.row.astype("int64")).to(dev)
    cols = torch.from_numpy(test.col.astype("int64")).to(dev)
    pred = (store.U_mean[rows] * store.V_mean[cols]).sum(-1)
    store_rmse = float(((pred - torch.from_numpy(test.val).to(dev)) ** 2)
                       .mean().sqrt())
    n_u, n_v = indefinite_rows(res.U_agg.Lambda), indefinite_rows(
        res.V_agg.Lambda)
    log(f"[serve] store posterior-mean scores: test RMSE {store_rmse:.4f} "
        f"(the chains' {res.rmse:.4f}, the mean predictor "
        f"{mean_rmse(train, test):.4f}); aggregated precisions indefinite "
        f"before the PD projection: {n_u} of {res.U_agg.eta.shape[0]} user "
        f"rows, {n_v} of {res.V_agg.eta.shape[0]} item rows")
    reqs = SERVE.build_requests(train, SERVE_REQUESTS, SERVE_MAX_SEEN,
                                seed=4)
    cold = cold_requests(train, SERVE_COLD, seed=5)
    kw = dict(k=SERVE_K, latency_budget_s=SERVE_BUDGET_S, max_batch=32,
              max_seen=SERVE_MAX_SEEN, max_fold=SERVE_FOLD, seed=3)
    for mode in ("mean", "thompson"):
        router = MicroBatchRouter(store, mode=mode, **kw)
        runs = [("real", reqs)] + ([("cold", cold)] if mode == "mean"
                                   else [])
        for label, rs in runs:
            tickets, wall = _serve_run(router, rs)
            lat = np.asarray(router.latencies_s)
            shapes = sorted({s for s, _ in router.dispatches})
            log(f"[serve] {mode} {label}: {len(lat)} requests in "
                f"{wall:.3f}s, QPS {len(lat) / wall:.0f}, p50 "
                f"{1e3 * np.percentile(lat, 50):.3f} ms, p99 "
                f"{1e3 * np.percentile(lat, 99):.3f} ms; "
                f"{len(router.dispatches)} dispatches over shapes {shapes} "
                f"(plan {router.plan_signatures})")
            if (mode, label) == ("mean", "real"):
                _serve_profile(router, rs)
            if mode == "mean":
                gap, top = brute_force_check(store, rs, tickets, SERVE_K)
                log(f"[serve] {mode} {label}: every answer within "
                    f"{SERVE_TOL:.0e} of the float64 brute-force k-th best; "
                    f"largest |served score - float64 score| {gap:.3e} "
                    f"(largest |score| served {top:.3g})")
            else:
                for r, t in zip(rs, tickets):
                    ids = t.ids[t.valid]
                    assert t.valid.all() and len(set(ids.tolist())) == SERVE_K
                    assert (ids < store.n_items).all()
                    assert not set(ids.tolist()) & set(r.seen)
                log(f"[serve] thompson: every answer holds {SERVE_K} valid, "
                    f"distinct, unseen items")
        # one warm scoring call (padding, copies in, scoring) that must not
        # synchronize the host with the card
        shape = router.bucket_for(32, SERVE_MAX_SEEN, 1)
        router.workers[0].score(router._pad_batch(reqs[:32], shape))
        torch.cuda.synchronize()
        with guards.no_host_transfers():
            router.workers[0].score(router._pad_batch(reqs[:32], shape))
        torch.cuda.synchronize()
        log(f"[serve] {mode}: one warm scoring call ran under "
            f"set_sync_debug_mode('error')")
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] peak device memory {peak / 2**30:.3f} GiB (the training "
        f"result's posteriors included)")


def enqueue_us(fn, n=1000, batch=100):
    """Host microseconds per call of ``fn``: ``n`` calls in runs of
    ``batch`` (few enough that the launch queue never fills), the host
    clock around each run's enqueues only, a device sync between runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n // batch):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return 1e6 * total / n


def lint_enqueue_cost(idx, val, mask, live, D, K, dev):
    """The enqueue cost per B2 call at the async executor's B = 1 shape
    (block 0 of the phase-c bucket), 1,000 launches each: the raw ctypes
    launcher with its arguments ready, the wrapper's launch path as the
    chains call it (checks, the output's allocation, the analyzer's
    ``note_kernel`` hook, not recording), and that path as a
    ``torch.library.custom_op`` (the other way to make B2 visible to a
    dispatch mode); the hook alone, not recording, 100,000 calls."""
    import torch
    from repro_torch.analysis import optrace as OPT
    from repro_torch.kernels.bmf_sweep import ops as B2
    idx, val, mask, live = (t[:1].contiguous() for t in (idx, val, mask,
                                                         live))
    _, N, M = idx.shape
    g = torch.Generator(device=dev).manual_seed(3)
    other = torch.randn((1, D, K), generator=g, device=dev) / K ** 0.5
    pe = torch.randn((1, N, K), generator=g, device=dev) * 0.3
    pl = (2 * torch.eye(K, device=dev)).expand(1, N, K, K).contiguous()
    z = torch.randn((1, N, K), generator=g, device=dev)
    U = torch.empty((1, N, K), device=dev)
    lib = B2._lib()
    args = (idx.data_ptr(), val.data_ptr(), mask.data_ptr(), live.data_ptr(),
            other.data_ptr(), 0, pe.data_ptr(), pl.data_ptr(), z.data_ptr(),
            U.data_ptr(), 1, N, M, D, K, 2.0, 1e-6,
            torch.cuda.current_stream(dev).cuda_stream)

    @torch.library.custom_op("chip_smoke::bmf_sweep", mutates_args=())
    def b2_op(z: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
              mask: torch.Tensor, pe: torch.Tensor, pl: torch.Tensor,
              other: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        return B2._launch(z, idx, val, mask, pe, pl, other, 2.0, 1e-6, live)

    @b2_op.register_fake
    def _(z, idx, val, mask, pe, pl, other, live):
        return torch.empty_like(z)

    ops = (z, idx, val, mask, pe, pl, other, live)
    raw = enqueue_us(lambda: lib(*args))
    path = enqueue_us(lambda: B2._launch(z, idx, val, mask, pe, pl, other,
                                         2.0, 1e-6, live))
    op = enqueue_us(lambda: b2_op(*ops))
    path2 = enqueue_us(lambda: B2._launch(z, idx, val, mask, pe, pl, other,
                                          2.0, 1e-6, live))
    raw2 = enqueue_us(lambda: lib(*args))
    hook = enqueue_us(lambda: OPT.note_kernel("x", {}, {}), n=100_000,
                      batch=100_000)
    log(f"[lint] B2 enqueue per call at the async B = 1 shape (N={N}, "
        f"M={M}, D={D}, K={K}), 1,000 launches each, in turns: raw ctypes "
        f"launcher {raw:.2f} / {raw2:.2f} us; the wrapper's launch path "
        f"(checks, output allocation, note_kernel hook) {path:.2f} / "
        f"{path2:.2f} us; as a torch.library.custom_op {op:.2f} us "
        f"(+{op - min(path, path2):.2f} us over the launch path); "
        f"note_kernel alone, not recording, {hook:.3f} us")


def phase_lint(part, test, test_p, K, dev):
    """``[lint]``: the analyzer on the card. ``bmf_lint`` over every
    executor on 1x1 and on Topology(2, 2) (four slots as streams of the
    card), serving and the kernels, and each pass's negative case on CUDA
    tensors (it must fire, its clean twin stay quiet);
    then one stacked phase-c chain of this run's bucket at full width (one
    sweep: the fused sweep fp32 and bf16, and use_kernel), its op trace
    against ``materialization_budget`` at those dims, with the largest
    buffer and the ops seen; the recompilation-budget pass on the
    partition's plans; B2's enqueue cost (``lint_enqueue_cost``). Returns
    the B1 and B2 launches of the lint and the full-width chains."""
    import torch
    from repro_torch import analysis as LINT
    from repro_torch.analysis import optrace as OPT
    from repro_torch.analysis.op_passes import materialization_budget
    from repro_torch.core import bmf as BMF
    from repro_torch.core import engine as ENG
    from repro_torch.core import gibbs as GIBBS
    from repro_torch.core import pp as PP
    from repro_torch.core.posterior import RowGaussians
    from repro_torch.data.sparse import PaddedCSR, row_live
    from repro_torch.launch import bmf_lint as LINTCLI
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    rc = LINTCLI.main(["--all-executors", "--topo", "2", "2", "--device",
                       "cuda"])
    rep = json.loads(LINTCLI.OUT.read_text())
    log(f"[lint] bmf_lint --all-executors --topo 2 2 --device cuda "
        f"(self-check included): exit {rc}, {rep['n_violations']} "
        f"violation(s) over "
        f"{len(rep['runs'])} runs, {len(rep['self_check'])} negative cases, "
        f"kernel ops {rep['kernel_ops']}, {time.time() - t0:.1f}s")
    assert rc == 0, "[lint] bmf_lint failed"
    for kern in ("repro_torch::bmf_precision", "repro_torch::bmf_sweep"):
        assert rep["kernel_ops"].get(kern, 0) > 0, f"[lint] no {kern} op"

    # one stacked phase-c chain at full width, both priors propagated
    s = PP.BlockShapes.per_phase(part, test_p)["c"]
    tasks = [t for _, ts in ENG.build_phase_graph(part) for t in ts
             if t.phase == "c"]
    buf = PP.new_block_inputs(s, K, len(tasks), dev, False, False)
    for b, t in enumerate(tasks):
        PP.fill_block_inputs(buf, b, part.block(t.i, t.j), s, test_p)
    rows = PaddedCSR(buf["idx_r"], buf["val_r"], buf["mask_r"], s.n_cols)
    cols = PaddedCSR(buf["idx_c"], buf["val_c"], buf["mask_c"], s.n_rows)
    B, N, M = rows.idx.shape
    Dn, Mc = cols.idx.shape[1:]

    def prior(n):
        lam = (2 * torch.eye(K, device=dev)).expand(B, n, K, K)
        return RowGaussians(eta=torch.zeros((B, n, K), device=dev),
                            Lambda=lam.contiguous())

    up, vp = prior(N), prior(Dn)
    budget = materialization_budget(N, Dn, M, Mc, K, batch=B)
    base = BMF.BMFConfig(K=K, n_samples=1, burnin=0)
    for label, cfg, kern in (
            ("fused fp32", base._replace(sweep_fused=True),
             "repro_torch::bmf_sweep"),
            ("fused bf16", base._replace(sweep_fused=True,
                                         sweep_dtype="bf16"),
             "repro_torch::bmf_sweep"),
            ("use_kernel", base._replace(use_kernel=True),
             "repro_torch::bmf_precision")):
        with OPT.record() as tr:
            GIBBS.run_gibbs_stacked(list(range(B)), rows, cols, buf["tr"],
                                    buf["tc"], cfg, up, vp, device=dev)
        torch.cuda.synchronize()
        vs = LINT.analyze(LINT.OpArtifact(f"phase-c {label}", tr.ops,
                                          bytes_budget=budget))
        nb, op, dt, shape = OPT.largest_buffer(tr.ops)
        seen = OPT.op_counts(tr.ops)
        log(f"[lint] phase-c chain at full width, {label} (B={B} N={N} "
            f"M={M} D={Dn} M_c={Mc} K={K}, one sweep): {len(tr.ops)} ops, "
            f"{len(vs)} violation(s); largest buffer {nb / 2**20:.1f} MiB "
            f"({op} {dt}{list(shape)}) against the budget "
            f"{budget / 2**20:.1f} MiB ({nb / budget:.3f}); kernel ops "
            f"{OPT.kernel_counts(tr.ops)}; ops seen "
            + ", ".join(f"{k.split('::')[-1]} {n}"
                        for k, n in sorted(seen.items())))
        for v in vs:
            log(str(v))
        assert not vs, f"[lint] phase-c {label}: violations"
        assert seen[kern] > 0, f"[lint] phase-c {label}: {kern} not traced"
    torch.cuda.synchronize()
    counts = read_counts()
    by_path = {"bmf_precision": counts["bmf_precision"],
               "bmf_sweep": counts["bmf_sweep"]}
    log(f"[lint] launches by the lint path: {by_path}")

    for name in ("stacked", "streaming"):
        sigs = LINTCLI.plan_signatures(name, part, test, base)
        vs = LINT.analyze(LINT.PlanArtifact(f"{part.I}x{part.J} {name}",
                                            sigs))
        log(f"[lint] recompilation-budget on the {part.I}x{part.J} "
            f"partition's {name} plan: {len(set(map(repr, sigs)))} distinct "
            f"shapes (cap 8), {len(vs)} violation(s)")
        assert not vs, f"[lint] {name} plan over cap"
    live = row_live(rows.mask)
    lint_enqueue_cost(rows.idx, rows.val, rows.mask, live, Dn, K, dev)
    del buf, rows, cols, up, vp, live
    torch.cuda.empty_cache()
    return by_path


def phase_table2(dev):
    """``benchmarks/bench_rmse.py``'s methods and configurations on the
    MovieLens-20M shape with its rows cut to 1/8 (docstring, phase 4):
    RMSE and seconds per method beside the mean predictor, each below it;
    ALS on its dense path and through B1, within ALS_PATH_TOL of each
    other; then B1 at the whole matrix's padded CSR (both sides, ALS's
    final factors) against its plain version. Returns (B1's launches in
    the B1 ALS run, B1's two parity cases)."""
    import numpy as np
    import torch
    from repro_torch.baselines import (ALSConfig, CCDConfig, SGDConfig,
                                       run_als, run_ccd, run_sgd)
    from repro_torch.core import bmf as BMF
    from repro_torch.core import pp as PP
    from repro_torch.data.sparse import coo_to_padded_csr, row_live
    preset, train, test, _, part = make_data(TABLE2_MOVIELENS_CUT,
                                             TABLE2_BLOCKS)
    K = preset.K
    base = mean_rmse(train, test)

    def rmse(pred):
        return float(np.sqrt(np.mean((pred.cpu().numpy() - test.val) ** 2)))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    cfg = BMF.BMFConfig(K=K, n_samples=TABLE2_SAMPLES, burnin=TABLE2_BURNIN)
    results = {}
    res, secs = timed(lambda: PP.run_pp(0, part, cfg, test, device=dev))
    results["bmf_pp"] = (res.rmse, secs)
    (r_full, _, _), secs = timed(lambda: PP.run_full_bmf(0, train, test, cfg,
                                                         device=dev))
    results["bmf"] = (r_full, secs)
    csr_r = coo_to_padded_csr(train, device=dev)
    csr_c = coo_to_padded_csr(train.transpose(), device=dev)
    log(f"[table2] global padded CSR: users {tuple(csr_r.idx.shape)}, items "
        f"{tuple(csr_c.idx.shape)}")
    als = ALSConfig(K=K, n_iters=ALS_ITERS)
    (_, _, pred), secs = timed(lambda: run_als(0, csr_r, csr_c, test.row,
                                               test.col, als, device=dev))
    results["als"] = (rmse(pred), secs)
    reset_counts()
    (U, V, pred), secs = timed(lambda: run_als(
        0, csr_r, csr_c, test.row, test.col, als._replace(use_kernel=True),
        device=dev))
    b1_launches = read_counts()["bmf_precision"]
    results["als_b1"] = (rmse(pred), secs)
    (_, _, pred), secs = timed(lambda: run_sgd(
        0, train, test.row, test.col, SGDConfig(K=K, n_epochs=SGD_EPOCHS),
        device=dev))
    results["fpsgd"] = (rmse(pred), secs)
    (_, _, pred), secs = timed(lambda: run_ccd(
        0, csr_r, csr_c, test.row, test.col, CCDConfig(K=K, n_iters=CCD_ITERS),
        device=dev))
    results["ccd"] = (rmse(pred), secs)
    for method, (r, secs) in results.items():
        extra = (f", {secs / SGD_EPOCHS:.3f} s/epoch" if method == "fpsgd"
                 else "")
        log(f"[table2] {method}: RMSE {r:.4f} (mean predictor {base:.4f}) "
            f"in {secs:.2f}s{extra}")
        assert np.isfinite(r) and r < base, \
            f"table2 {method}: RMSE {r} does not beat the mean predictor"
    gap = abs(results["als"][0] - results["als_b1"][0])
    log(f"[table2] ALS dense vs B1: |RMSE gap| {gap:.3e} (limit "
        f"{ALS_PATH_TOL:.0e}); B1 launches {b1_launches}")
    assert gap <= ALS_PATH_TOL, f"ALS paths differ by {gap}"
    assert b1_launches == 2 * ALS_ITERS
    cases = []
    for side, csr, other in (("users", csr_r, V), ("items", csr_c, U)):
        idx, val, mask = csr.idx[None], csr.val[None], csr.mask[None]
        live = row_live(mask)
        log(f"[table2-parity] B1 {side}: N = {idx.shape[1]}, M = "
            f"{idx.shape[2]}, longest row {int(live.max())}, mean "
            f"{float(live.float().mean()):.1f} live slots")
        cases.append(dict(case=f"als-global-csr-{side}", dtype="fp32",
                          **b1_parity(idx, val, mask, live,
                                      other[None].contiguous(), 1.0,
                                      "table2-parity", plain_reps=1)))
    del csr_r, csr_c, U, V, res
    torch.cuda.empty_cache()
    return b1_launches, cases


def _sdpa_ms(q, k, v, reps, **kw):
    """The library yardstick: one ``scaled_dot_product_attention`` call on
    (B, H, S, hd) views of the same tensors, K/V repeated to the query
    heads before the timing so that every backend takes the call (timed
    here only; the port never calls it)."""
    import torch.nn.functional as F
    group = q.shape[-2] // k.shape[-2]
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(group, dim=2).transpose(1, 2)
              for t in (k, v))
    ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
                 reps)
    del kt, vt
    return ms


def _attn_bound(n_bytes, flops, dtype):
    """L1's or L2's bound as the kernels run their products: bf16 on the
    tensor cores; f32 as 3xTF32 (3 x flops at the TF32 peak, as
    ``roofline.op_cost`` costs them), with the bound on the CUDA cores
    (flops at the f32 peak) beside it. Returns (bound, extra fields)."""
    if dtype == "bf16":
        return bound(n_bytes, flops, "bf16"), {}
    return (bound(n_bytes, 3 * flops, "tf32"),
            dict(cuda_core_bound_ms=bound(n_bytes, flops, "fp32")[0]))


def _attn_line(name, case, dtype, err, scale, tol, ms, pms, bd, lib,
               n_bytes, tag="llm-parity", note="", **extra):
    ok = err <= tol * scale
    variant = (f" ({'sm90' if dtype == 'bf16' else '3xTF32 f32'} kernel)"
               if name.startswith("flash_attention") else "")
    cc = (f", CUDA-core bound {extra['cuda_core_bound_ms']:.4f} ms"
          if "cuda_core_bound_ms" in extra else "")
    log(f"[{tag}] {name}{variant} {case} {dtype}: max_abs_err {err:.3e} "
        f"(tolerance {tol:.3g} x {scale:.3g} = {tol * scale:.3e}) "
        f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms "
        f"({n_bytes / ms / 1e9:.3f} TB/s), plain {pms:.3f} ms, "
        f"bound {bd[0]:.4f} ms ({bd[1]}){cc}, library (SDPA"
        f"{' backward' if name == 'flash_attention_bwd' else ''}) "
        f"{lib:.4f} ms{note}")
    if not ok:
        raise AssertionError(f"{name} {case} {dtype} disagrees with its "
                             f"plain version")
    return dict(case=case, dtype=dtype, max_abs_err=err, ms=ms,
                plain_ms=pms, bound_ms=bd[0], bound_by=bd[1],
                library_ms=lib, tb_per_s=n_bytes / ms / 1e9, **extra)


def _tdt(dtype):
    import torch
    return {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]


def _l1_case(g, dev, case, B, S, H, Hkv, hd, causal, window, dtype,
             tag="llm-parity", Skv=None):
    """L1 against its plain version (on the first LLM_CHECK sequences),
    timed at the full batch beside the plain version, the bound and SDPA;
    S queries over ``Skv`` keys (by default S)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as L1
    from repro_torch.kernels.flash_attention.ref import attention_mask
    Skv = Skv or S
    mask = attention_mask(S, Skv, causal, window, dev)
    pairs = int(mask.sum())
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(_tdt(dtype))
    k, v = (torch.randn((B, Skv, Hkv, hd), generator=g,
                        device=dev).to(_tdt(dtype)) for _ in range(2))

    def kern():
        return L1.flash_attention(q, k, v, causal=causal, window=window)

    def plain():
        return [L1.flash_attention_ref(
            q[b:b + LLM_CHECK], k[b:b + LLM_CHECK], v[b:b + LLM_CHECK],
            causal=causal, window=window).to(q.dtype)
            for b in range(0, B, LLM_CHECK)]

    out = kern()[:LLM_CHECK].float()
    want = L1.flash_attention_ref(
        q[:LLM_CHECK], k[:LLM_CHECK], v[:LLM_CHECK], causal=causal,
        window=window).to(q.dtype).float()
    err = float((out - want).abs().max())
    scale = max(float(want.abs().max()), 1.0)
    del out, want
    ms, pms = cuda_ms(kern, 3, warmup=1), cuda_ms(plain, 1, warmup=0)
    torch.cuda.empty_cache()
    if window:
        lib = _sdpa_ms(q, k, v, 3, attn_mask=mask)
    else:
        lib = _sdpa_ms(q, k, v, 3, is_causal=causal)
    elt = q.element_size()
    n_bytes = elt * (2 * q.numel() + k.numel() + v.numel())
    bd, extra = _attn_bound(n_bytes, 4 * B * H * hd * pairs, dtype)
    del q, k, v, mask
    torch.cuda.empty_cache()
    return _attn_line("flash_attention", case, dtype, err, scale,
                      ATTN_TOL[dtype], ms, pms, bd, lib, n_bytes, tag=tag,
                      **extra)


def _l3_case(g, dev, case, B, S, H, Hkv, hd, window, dtype,
             tag="llm-parity"):
    """L3 against its plain version over a cache laid out as ``case``
    says (its name holds full, empty or else is a ring), timed beside the
    bound and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as L3
    from repro_torch.kernels.decode_attention.ref import slot_valid
    if "full" in case:
        kv_pos, q_pos = torch.arange(S, device=dev), S - 1
    elif "empty" in case:
        n = int(0.6 * S)
        ar = torch.arange(S, device=dev)
        kv_pos, q_pos = torch.where(ar < n, ar, -1), n - 1
    else:
        q_pos = 3 * S + 17
        p = torch.arange(q_pos - S + 1, q_pos + 1, device=dev)
        kv_pos = torch.empty(S, dtype=torch.long, device=dev)
        kv_pos[p % S] = p
        kv_pos[[(q_pos - 5) % S, (q_pos - S + 3) % S]] = -1
    kv_pos = kv_pos.to(torch.int32)
    valid = slot_valid(kv_pos, q_pos, window)
    n_valid = int(valid.sum())
    q = torch.randn((B, H, hd), generator=g, device=dev).to(_tdt(dtype))
    k, v = (torch.randn((B, S, Hkv, hd), generator=g,
                        device=dev).to(_tdt(dtype)) for _ in range(2))

    def kern():
        return L3.decode_attention(q, k, v, kv_pos, q_pos, window=window)

    def plain():
        return L3.decode_attention_ref(q, k, v, kv_pos, q_pos,
                                       window).to(q.dtype)

    out, want = kern().float(), plain().float()
    err = float((out - want).abs().max())
    scale = max(float(want.abs().max()), 1.0)
    # ms and library_ms: one call between events, the measure of every
    # earlier row (it counts the host's enqueue of a ~0.1 ms kernel); beside
    # them the device time per call in a CUDA graph, for both alike
    ms, pms = cuda_ms(kern, 20), cuda_ms(plain, 5)
    group = H // Hkv
    qt = q[:, :, None]
    kt, vt = (t.repeat_interleave(group, dim=2).transpose(1, 2)
              for t in (k, v))
    mask = valid[None, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    lib = cuda_ms(sdpa, 20)
    dev_ms, dev_lib = graph_ms(kern), graph_ms(sdpa)
    # what one call between events costs for the least work: a one-element
    # add_, whose enqueue and launch sit in the window as the kernel's do
    one = torch.zeros(1, device=dev)
    floor = cuda_ms(lambda: one.add_(1), 20)
    del kt, vt
    elt = q.element_size()
    n_bytes = (2 * B * Hkv * hd * k.element_size() * n_valid
               + 2 * q.numel() * elt + 4 * S)
    bd = bound(n_bytes, 4 * B * H * hd * n_valid, dtype)
    n_splits, chunk = L3.split_plan(
        B, Hkv, S, hd, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    if case.endswith(("full-4096", "full-32768")) and dtype == "bf16":
        _l3_split_sweep(q, k, v, kv_pos, q_pos, n_splits, case, tag)
    del q, k, v
    torch.cuda.empty_cache()
    return _attn_line(
        "decode_attention", case, dtype, err, scale, ATTN_TOL[dtype], ms,
        pms, bd, lib, n_bytes, tag=tag,
        note=(f" (one call each); device time per call (CUDA graph): kernel "
              f"{dev_ms:.4f} ms ({n_bytes / dev_ms / 1e9:.3f} TB/s), SDPA "
              f"{dev_lib:.4f} ms; one-call floor (a one-element add_) "
              f"{floor:.4f} ms; {n_splits} splits of {chunk} slots"),
        device_ms_per_call=dev_ms, library_device_ms_per_call=dev_lib,
        device_tb_per_s=n_bytes / dev_ms / 1e9, one_call_floor_ms=floor,
        splits=n_splits)


def _l1_long_case(g, dev, case, S, H, Hkv, hd, dtype, check_rows,
                  tag="llm-parity"):
    """L1 at one causal sequence of S positions (prefill_32k's length),
    held against its plain version on the last ``check_rows`` query rows
    (positions S - check_rows ... S - 1, which see all but the last keys):
    the plain version's (S, S) f32 scores would not fit the card. Timed
    beside the bound and SDPA; ``plain_ms`` is the plain version on those
    rows."""
    import torch
    from repro_torch.kernels.flash_attention import ops as L1
    q = torch.randn((1, S, H, hd), generator=g, device=dev).to(_tdt(dtype))
    k, v = (torch.randn((1, S, Hkv, hd), generator=g,
                        device=dev).to(_tdt(dtype)) for _ in range(2))

    def kern():
        return L1.flash_attention(q, k, v, causal=True)

    def plain():
        return L1.flash_attention_ref(
            q[:, -check_rows:], k, v, causal=True,
            q_offset=S - check_rows).to(q.dtype)

    out = kern()[:, -check_rows:].float()
    want = plain().float()
    err = float((out - want).abs().max())
    scale = max(float(want.abs().max()), 1.0)
    del out, want
    torch.cuda.empty_cache()
    ms, pms = cuda_ms(kern, 3, warmup=1), cuda_ms(plain, 1, warmup=0)
    torch.cuda.empty_cache()
    lib = _sdpa_ms(q, k, v, 3, is_causal=True)
    pairs = S * (S + 1) // 2
    elt = q.element_size()
    n_bytes = elt * (2 * q.numel() + k.numel() + v.numel())
    bd, extra = _attn_bound(n_bytes, 4 * H * hd * pairs, dtype)
    del q, k, v
    torch.cuda.empty_cache()
    return _attn_line("flash_attention", case, dtype, err, scale,
                      ATTN_TOL[dtype], ms, pms, bd, lib, n_bytes, tag=tag,
                      note=f" (held and plain-timed on the last "
                           f"{check_rows} query rows; {pairs} causal pairs)",
                      **extra)


def _l3_split_sweep(q, k, v, kv_pos, q_pos, n_plan, case, tag):
    """Device ms per call of L3's kernels at other split counts than
    ``split_plan``'s, through the C entry point (the wrapper's launch count
    does not move): the measurement the plan's one-wave rule rests on."""
    import torch
    from repro_torch.kernels import build as BUILD
    from repro_torch.kernels.decode_attention import ops as L3
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    tiles = -(-S // L3.TILE)
    found = {}
    for n_try in (n_plan, 2 * n_plan, 4 * n_plan, 8 * n_plan,
                  max(1, n_plan // 2)):
        chunk = -(-tiles // n_try) * L3.TILE
        nc = -(-S // chunk)
        if nc in found:
            continue
        o = torch.empty_like(q)
        part_acc = torch.empty((B, Hkv, nc, H // Hkv, hd),
                               device=q.device)
        part_ml = torch.empty((B, Hkv, nc, H // Hkv, 2), device=q.device)

        def call():
            BUILD.check(L3._lib()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
                o.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), 1, 1,
                B, S, H, Hkv, hd, q_pos, 0, chunk,
                torch.cuda.current_stream().cuda_stream),
                "decode_attention_launch")

        found[nc] = graph_ms(call)
    log(f"[{tag}] decode_attention {case} bf16 device ms by split count "
        f"(B * Hkv = {B * Hkv} blocks per split; split_plan takes "
        f"{n_plan}): " + ", ".join(f"{n}: {ms:.4f}"
                                   for n, ms in sorted(found.items())))


def phase_llm_parity(dev):
    """L1 and L3 against their plain versions at the serve path's shapes."""
    import torch
    from repro_torch.configs.base import get_config
    cfg = get_config(LLM_ARCH)
    B, H, Hkv, hd = LLM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(0)
    results = {"flash_attention": [], "decode_attention": []}
    for case, S, causal, window in (("causal-4000", LLM_PROMPT, True, 0),
                                    ("window1024-4000", LLM_PROMPT, True,
                                     1024),
                                    ("noncausal-4096", LLM_CONTEXT, False,
                                     0)):
        for dtype in ("bf16", "fp32"):
            results["flash_attention"].append(_l1_case(
                g, dev, case, B, S, H, Hkv, hd, causal, window, dtype))
    for case, S, window in (("full-4096", LLM_CONTEXT, 0),
                            ("empty-ragged-4033", 4033, 0),
                            ("ring-window1000-4096", LLM_CONTEXT, 1000)):
        for dtype in ("bf16", "fp32"):
            results["decode_attention"].append(_l3_case(
                g, dev, case, B, S, H, Hkv, hd, window, dtype))
    # the serving shapes' attention: L1 over prefill_32k's one 32,768-token
    # prompt, L3 over decode_32k's 32,768 filled slots at [int8-decode]'s
    # batch (its bf16 comparator)
    results["flash_attention"].append(_l1_long_case(
        g, dev, "causal-32768-B1", SHAPE_SEQ, H, Hkv, hd, "bf16",
        L1_LONG_CHECK_ROWS))
    results["decode_attention"].append(_l3_case(
        g, dev, "full-32768", INT8_BATCH, SHAPE_SEQ, H, Hkv, hd, 0, "bf16"))
    torch.cuda.empty_cache()
    return results


def phase_hd112_parity(dev):
    """L1, L3 and L2 at zamba2's shared attention block (MHA, H = Hkv =
    32, hd = 112): causal prefill at 4,000 tokens, decode over a full
    4,096-slot ring, and L2 with the autograd Function at the train
    shape (B = 2, S = 4,096, causal)."""
    import torch
    from repro_torch.configs.base import get_config
    cfg = get_config(HYBRID_ARCH)
    B, H, Hkv, hd = LLM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(2)
    results = {"flash_attention": [], "decode_attention": [],
               "flash_attention_bwd": []}
    for dtype in ("bf16", "fp32"):
        results["flash_attention"].append(_l1_case(
            g, dev, "hd112-causal-4000", B, LLM_PROMPT, H, Hkv, hd, True, 0,
            dtype, tag="hd112-parity"))
    for dtype in ("bf16", "fp32"):
        results["decode_attention"].append(_l3_case(
            g, dev, "hd112-full-4096", B, LLM_CONTEXT, H, Hkv, hd, 0, dtype,
            tag="hd112-parity"))
    # the sm90 L2 runs hd 112 in its 128-column tiles, the f32 one as its
    # own instantiation
    for dtype in ("bf16", "fp32"):
        results["flash_attention_bwd"].append(_l2_case(
            g, dev, "hd112-causal-4096", L2_BATCH, L2_SEQ, H, Hkv, hd, True,
            0, dtype, tag="hd112-parity"))
    for dtype in ("bf16", "fp32"):
        _l2_e2e(g, dev, L2_SEQ, H, Hkv, hd, dtype, "hd112-causal-4096",
                tag="hd112-parity")
    torch.cuda.empty_cache()
    return results


def phase_whisper_parity(dev):
    """L1, L3 and L2 at whisper-medium's attention (MHA: H = Hkv = 16, hd
    64, group 1), bf16 as served and trained: L1 over the encoder's 1,500
    frames (non-causal, ragged: 23 x 64 + 28), the decoder's causal
    4,000-token prompt and its cross-attention (4,000 queries over 1,500
    frames); L3 over a full 4,096-slot self cache and the 1,500-slot cross
    cache (every slot counts); L2 at B = 2 over the encoder's frames and
    the cross-attention of 4,096 queries over 1,500 frames. The f32
    kernels of L1 and L2 also run the encoder's frames: their only case
    at hd 64 and group 1 with a ragged edge on both axes."""
    import torch
    from repro_torch.configs.base import get_config
    cfg = get_config(WHISPER_ARCH)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    F, tag = cfg.n_audio_frames, "whisper-parity"
    pre = f"hd{hd}-group{H // Hkv}"
    g = torch.Generator(device=dev).manual_seed(4)
    results = {"flash_attention": [], "decode_attention": [],
               "flash_attention_bwd": []}
    for case, S, Skv, causal in (
            (f"encoder-noncausal-{F}", F, F, False),
            (f"decoder-causal-{LLM_PROMPT}", LLM_PROMPT, LLM_PROMPT, True),
            (f"cross-{LLM_PROMPT}x{F}", LLM_PROMPT, F, False)):
        results["flash_attention"].append(_l1_case(
            g, dev, f"{pre}-{case}", LLM_BATCH, S, H, Hkv, hd, causal, 0,
            "bf16", tag=tag, Skv=Skv))
    encoder = f"{pre}-encoder-noncausal-{F}"
    results["flash_attention"].append(_l1_case(
        g, dev, encoder, LLM_BATCH, F, H, Hkv, hd, False, 0, "fp32",
        tag=tag))
    for case, S in ((f"self-full-{LLM_CONTEXT}", LLM_CONTEXT),
                    (f"cross-full-{F}", F)):
        results["decode_attention"].append(_l3_case(
            g, dev, f"{pre}-{case}", LLM_BATCH, S, H, Hkv, hd, 0, "bf16",
            tag=tag))
    for case, S, Skv in ((f"encoder-noncausal-{F}", F, F),
                         (f"cross-{L2_SEQ}x{F}", L2_SEQ, F)):
        results["flash_attention_bwd"].append(_l2_case(
            g, dev, f"{pre}-{case}", L2_BATCH, S, H, Hkv, hd, False, 0,
            "bf16", tag=tag, Skv=Skv))
    results["flash_attention_bwd"].append(_l2_case(
        g, dev, encoder, L2_BATCH, F, H, Hkv, hd, False, 0, "fp32", tag=tag))
    torch.cuda.empty_cache()
    return results


def phase_hd64_parity(dev):
    """L1 and L3 at the moe and vlm families' hd 64 attention, bf16 and
    fp32: Granite-MoE (H = 16 over Hkv = 8, group 2) and InternVL2 (H = 14
    over Hkv = 2, group 7); causal prefill at 4,000 positions, decode over
    a full 4,096-slot cache."""
    import torch
    from repro_torch.configs.base import get_config
    g = torch.Generator(device=dev).manual_seed(3)
    results = {"flash_attention": [], "decode_attention": []}
    for arch in (MOE_ARCH, VLM_ARCH):
        cfg = get_config(arch)
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        case = f"hd{hd}-group{H // Hkv}"
        for dtype in ("bf16", "fp32"):
            results["flash_attention"].append(_l1_case(
                g, dev, f"{case}-causal-4000", LLM_BATCH, LLM_PROMPT, H, Hkv,
                hd, True, 0, dtype, tag="hd64-parity"))
        for dtype in ("bf16", "fp32"):
            results["decode_attention"].append(_l3_case(
                g, dev, f"{case}-full-4096", LLM_BATCH, LLM_CONTEXT, H, Hkv,
                hd, 0, dtype, tag="hd64-parity"))
    torch.cuda.empty_cache()
    return results


# the examples as a user runs them, at their defaults (the reference's),
# the LLM one at the moe family's two archs and the audio family's
EXAMPLES = (("torch_e2e_bmf_webscale", ()),
            ("torch_pp_block_exploration", ()),
            ("torch_distributed_block", ()),
            ("torch_llm_smoke_train", ("--arch", MIXTRAL_ARCH)),
            ("torch_llm_smoke_train", ("--arch", MOE_ARCH)),
            ("torch_llm_smoke_train", ("--arch", WHISPER_ARCH)))
EXAMPLE_TIMEOUT_S = 600


def phase_examples():
    """The port's examples as subprocesses on the card, all started
    together: each must exit 0 with ``OK`` as its last line. A failure
    stops the others."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.time()
    procs = [(name, args, subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for name, args in EXAMPLES]
    try:
        for name, args, proc in procs:
            out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            lines = out.strip().splitlines()
            log(f"[examples] {name} {' '.join(args)}: exit "
                f"{proc.returncode} by {time.time() - t0:.1f}s; "
                + " | ".join(lines[-4:]))
            if proc.returncode != 0 or not lines or lines[-1] != "OK":
                raise AssertionError(f"{name} {args} failed:\n{out[-3000:]}"
                                     f"\n{err[-3000:]}")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _scan_inputs(g, dev, name, B, S, H, N, P, case):
    """Inputs of L4 (``name`` "ssd_chunk": xdt, a, B, C, state0) or L5
    ("wkv6": r, k, v, logw, u, state0) at the serve path's shape, f32,
    with the decay of zamba2's and rwkv6's random layers. ``case`` asks
    for a zero state0 ("zero"; else random), 96 identity steps at the end
    ("padded": a 4,000-token prompt padded as the mixers pad it, the serve
    path's own call) or strong decay ("strong")."""
    import torch
    import torch.nn.functional as F

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    if name == "ssd_chunk":
        dt = F.softplus(randn(B, S, H, scale=0.5) - 2.0)   # dt_bias = -2
        if case.startswith("strong"):
            a = -2.0 + randn(B, S, H, scale=0.1)
        else:
            a = -torch.linspace(1.0, 16.0, H, device=dev) * dt
        seq = [randn(B, S, H, P) * dt[..., None], a, randn(B, S, N),
               randn(B, S, N)]
        state = randn(B, H, P, N, scale=0.1)
        extra = []
    else:
        logw = (-1.0 + randn(B, S, H, N, scale=0.1) if case.startswith(
            "strong") else -torch.exp(randn(B, S, H, N) - 3.0))
        seq = [randn(B, S, H, N), randn(B, S, H, N, scale=0.5),
               randn(B, S, H, N), logw]
        state = randn(B, H, N, N, scale=0.1)
        extra = [randn(H, N, scale=0.1)]
    if "zero" in case:
        state.zero_()
    if "padded" in case:
        for t in seq:
            t[:, LLM_PROMPT:] = 0.0
    return seq + extra + [state]


def phase_scan_parity(dev):
    """L4 and L5 against their plain chunked versions, f32, at the serve
    path's shapes (B = 8, S = 4,096; zamba2: H = 112, P = N = 64; rwkv6:
    H = 64, N = 64), timed beside the bound and the plain version."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.ssd_chunk import ops as L4
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunked
    from repro_torch.kernels.wkv6 import ops as L5
    from repro_torch.kernels.wkv6.ref import wkv_chunked
    hyb, ssm = get_config(HYBRID_ARCH), get_config(SSM_ARCH)
    B, S = LLM_BATCH, LLM_CONTEXT
    shapes = {
        "ssd_chunk": (L4.ssd_scan, ssd_chunked,
                      hyb.ssm_expand * hyb.d_model // hyb.ssm_head_dim,
                      hyb.ssm_state, hyb.ssm_head_dim),
        "wkv6": (L5.wkv6, wkv_chunked, ssm.d_model // ssm.wkv_head_dim,
                 ssm.wkv_head_dim, ssm.wkv_head_dim)}
    g = torch.Generator(device=dev).manual_seed(3)
    results = {name: [] for name in shapes}
    for name, (kern_fn, plain_fn, H, N, P) in shapes.items():
        for case in ("state0-zero-4000-padded", "state0-random-4096",
                     "strong-decay-4096"):
            args = _scan_inputs(g, dev, name, B, S, H, N, P, case)
            got, want = kern_fn(*args), plain_fn(*args)
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            err, scale = _rel_err(got, want)
            del got, want
            ms = cuda_ms(lambda: kern_fn(*args), 5)
            pms = cuda_ms(lambda: plain_fn(*args), 1, warmup=0)
            # each input read once, y and the state written once; the
            # recurrence's own operations: per step and head 2 P N for the
            # state update and 2 P N for y_t (the sequential form, the
            # least any scan does; the chunked forms do more)
            n_bytes = 4 * (sum(t.numel() for t in args) + args[0].numel()
                           + args[-1].numel())
            bytes_ms = 1e3 * n_bytes / _roof().HBM_BW
            note = f"bytes alone {bytes_ms:.4f} ms"
            # both multiply on the tensor cores in bf16, each product three
            # times (hi.hi + hi.lo + lo.hi) over 64-step chunks. L4: per
            # head and chunk C S^T and (w x)^T B (128 P N each) and M X on
            # the 10 lower-triangle 16 x 16 tiles (5,120 P); per batch row
            # and chunk C B^T on 20 16 x 8 tiles (5,120 N). L5 (P = N): per
            # head and chunk r2 (e^c S) and k2^T v (128 N^2 each), r2 k2^T
            # on 20 16 x 8 tiles and A v on 10 16 x 16 tiles (5,120 N
            # each). Their bound is the larger of those at the bf16 rate
            # and the bytes
            if name == "ssd_chunk":
                flops = 3 * B * (S // 64) * (H * (256 * P * N + 5120 * P)
                                             + 5120 * N)
            else:
                flops = 3 * B * (S // 64) * H * (256 * N * N + 10240 * N)
            seq_ms = (1e3 * 4 * B * S * H * P * N
                      / _roof().PEAK_FLOPS["fp32"])
            note += (f", f32 sequential operations {seq_ms:.4f} ms (the "
                     f"first designs multiplied on the CUDA cores), bf16 "
                     f"split products "
                     f"{1e3 * flops / _roof().PEAK_FLOPS['bf16']:.4f} ms")
            bd = bound(n_bytes, flops, "bf16")
            ok = finite and err <= SCAN_TOL * scale
            log(f"[scan-parity] {name} {case} fp32: max_abs_err {err:.3e} "
                f"(tolerance {SCAN_TOL:.0e} x {scale:.3g} = "
                f"{SCAN_TOL * scale:.3e}) {'ok' if ok else 'FAIL'}; kernel "
                f"{ms:.3f} ms ({n_bytes / ms / 1e9:.3f} TB/s), plain "
                f"{pms:.3f} ms, bound {bd[0]:.4f} ms ({bd[1]}; {note}), "
                f"library none")
            if not ok:
                raise AssertionError(f"{name} {case} disagrees with its "
                                     "plain version")
            results[name].append(dict(case=case, dtype="fp32",
                                      max_abs_err=err, ms=ms, plain_ms=pms,
                                      bound_ms=bd[0], bound_by=bd[1],
                                      library_ms=None,
                                      tb_per_s=n_bytes / ms / 1e9))
            del args
            torch.cuda.empty_cache()
    return results


def _scan_train_inputs(g, dev, name, H, N, P, strong):
    """The training scan's inputs, f32 leaves that need a gradient, at B =
    SCAN_TRAIN_B, S = SCAN_TRAIN_S: (x, dt, A_log, B, C, state0) in the
    reference's ``ssd_chunked`` layout for "ssd_chunk" (dt = softplus(noise
    − 2), A_log = log(linspace(1, 16)), as a random layer has; ``strong``:
    a ≈ −2 per step) or (r, k, v, logw, u, state0) for "wkv6" (``strong``:
    log w ≈ −1); and cotangents for y and the final state."""
    import torch
    import torch.nn.functional as F
    B, S = SCAN_TRAIN_B, SCAN_TRAIN_S

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    if name == "ssd_chunk":
        if strong:
            dt = F.softplus(1.0 + randn(B, S, H, scale=0.1))
            A_log = torch.full((H,), math.log(2.0 / math.log1p(math.e)),
                               device=dev)
        else:
            dt = F.softplus(randn(B, S, H, scale=0.5) - 2.0)
            A_log = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
        args = [randn(B, S, H, P), dt, A_log, randn(B, S, N), randn(B, S, N),
                randn(B, H, P, N, scale=0.1)]
        cots = [randn(B, S, H, P), randn(B, H, P, N)]
    else:
        logw = (-1.0 + randn(B, S, H, N, scale=0.1) if strong
                else -torch.exp(randn(B, S, H, N) - 3.0))
        args = [randn(B, S, H, N), randn(B, S, H, N, scale=0.5),
                randn(B, S, H, N), logw, randn(H, N, scale=0.1),
                randn(B, H, N, N, scale=0.1)]
        cots = [randn(B, S, H, N), randn(B, H, N, N)]
    return [t.requires_grad_() for t in args], cots


def phase_scan_train_parity(dev):
    """The training scans (``ssd_scan_train``, ``wkv_scan_train``: the
    route a prompt takes when autograd records a gradient) at the full
    models' head counts (zamba2: H = 112, P = N = 64; rwkv6: H = 64, N =
    64), B 1, S 512, f32: y and the final state against L4 / L5 on the
    same inputs within SCAN_TRAIN_TOL, and the gradients with respect to
    every input against autograd through the sequential oracles within
    SCAN_GRAD_TOL; a random layer's decay and strong decay. The training
    scan's forward and backward are timed beside the kernel's forward."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.ssd_chunk import ops as L4
    from repro_torch.kernels.ssd_chunk.ref import ssd_sequential
    from repro_torch.kernels.wkv6 import ops as L5
    from repro_torch.kernels.wkv6.ref import wkv_sequential
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import rwkv6 as R6
    hyb, ssm = get_config(HYBRID_ARCH), get_config(SSM_ARCH)

    def ssd_kernel(x, dt, A_log, B_, C_, s0):
        a = -torch.exp(A_log)[None, None, :] * dt
        return L4.ssd_scan(x * dt[..., None], a.contiguous(), B_, C_, s0)

    def ssd_oracle(x, dt, A_log, B_, C_, s0):
        a = -torch.exp(A_log)[None, None, :] * dt
        return ssd_sequential(x * dt[..., None], a, B_, C_, s0)

    scans = {
        "ssd_chunk": (M2.ssd_scan_train, ssd_kernel, ssd_oracle,
                      hyb.ssm_expand * hyb.d_model // hyb.ssm_head_dim,
                      hyb.ssm_state, hyb.ssm_head_dim,
                      ("x", "dt", "A_log", "B", "C", "state0")),
        "wkv6": (R6.wkv_scan_train, L5.wkv6, wkv_sequential,
                 ssm.d_model // ssm.wkv_head_dim, ssm.wkv_head_dim,
                 ssm.wkv_head_dim, ("r", "k", "v", "logw", "u", "state0"))}
    g = torch.Generator(device=dev).manual_seed(4)
    for name, (train_fn, kern_fn, oracle, H, N, P, names) in scans.items():
        for strong in (False, True):
            case = "strong-decay" if strong else "decay"
            args, cots = _scan_train_inputs(g, dev, name, H, N, P, strong)

            def fwd_bwd(fn):
                for t in args:
                    t.grad = None
                out = fn(*args)
                torch.autograd.backward(out, cots)
                return [t.detach() for t in out], [t.grad for t in args]

            out, grads = fwd_bwd(train_fn)
            with torch.no_grad():
                kern = kern_fn(*args)
            v_err, v_scale = _rel_err(out, kern)
            finite = all(bool(torch.isfinite(t).all()) for t in out + grads)
            want_out, want_grads = fwd_bwd(oracle)
            worst = max(((float((a - b).abs().max())
                          / max(float(b.abs().max()), 1.0), n)
                         for a, b, n in zip(out + grads,
                                            want_out + want_grads,
                                            ("y", "state", *names))),
                        key=lambda e: e[0])
            ms = cuda_ms(lambda: fwd_bwd(train_fn), 3, warmup=1)
            with torch.no_grad():
                kms = cuda_ms(lambda: kern_fn(*args), 3, warmup=1)
            ok = (finite and v_err <= SCAN_TRAIN_TOL * v_scale
                  and worst[0] <= SCAN_GRAD_TOL)
            log(f"[scan-train-parity] {name} {case} B {SCAN_TRAIN_B} S "
                f"{SCAN_TRAIN_S} H {H} fp32: training scan vs the kernel "
                f"max_abs_err {v_err:.3e} (tolerance {SCAN_TRAIN_TOL:.0e} x "
                f"{v_scale:.3g}); gradients and values vs the sequential "
                f"oracle: worst {worst[0]:.3e} of the largest ({worst[1]}; "
                f"tolerance {SCAN_GRAD_TOL:.0e}) {'ok' if ok else 'FAIL'}; "
                f"training scan forward + backward {ms:.3f} ms, kernel "
                f"forward {kms:.3f} ms")
            if not ok:
                raise AssertionError(f"{name} training scan {case} "
                                     "disagrees with the kernel or oracle")
            del args, cots, out, grads, kern, want_out, want_grads
            torch.cuda.empty_cache()


def _describe(cfg):
    if cfg.family == "ssm":
        mix = f"{cfg.d_model // cfg.wkv_head_dim} WKV heads of " \
              f"{cfg.wkv_head_dim}, d_ff {cfg.d_ff}"
    else:
        mix = f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}"
        if cfg.family == "hybrid":
            d_in = cfg.ssm_expand * cfg.d_model
            mix += (f" (shared block after every {cfg.shared_attn_period} "
                    f"layers), d_inner {d_in}, {d_in // cfg.ssm_head_dim} "
                    f"SSM heads of {cfg.ssm_head_dim}, state "
                    f"{cfg.ssm_state}")
        if cfg.family == "moe":
            mix += (f", {cfg.n_experts} experts of d_ff {cfg.d_ff}, top "
                    f"{cfg.experts_per_token}, capacity factor "
                    f"{cfg.moe_capacity_factor}")
        elif cfg.family != "hybrid":
            mix += f", d_ff {cfg.d_ff}"
        if cfg.sliding_window:
            mix += f", window {cfg.sliding_window}"
        if cfg.family == "vlm":
            mix += f", {cfg.n_image_tokens} image positions"
        if cfg.is_encdec:
            mix += (f", {cfg.n_encoder_layers} encoder layers over "
                    f"{cfg.n_audio_frames} stub frames, cross-attention in "
                    f"every decoder layer")
    return (f"{cfg.name} ({cfg.family}): {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {mix}, vocab {cfg.vocab_size} (padded "
            f"{cfg.padded_vocab_size})")


def _attention_calls(cfg):
    """(decoder-side attention calls, encoder calls) of one forward: one
    per layer; the audio family's decoder layers two (self and cross) and
    its encoder layers one; the hybrid family's shared block one per full
    group; the ssm family none."""
    return ({"dense": cfg.n_layers, "moe": cfg.n_layers,
             "vlm": cfg.n_layers, "audio": 2 * cfg.n_layers,
             "hybrid": cfg.n_layers // max(cfg.shared_attn_period, 1),
             "ssm": 0}[cfg.family], cfg.n_encoder_layers)


def _expected_launches(cfg, n_steps):
    """The kernels the serve path must launch, by family: L1 per
    attention layer in prefill, every one the bf16 sm90 kernel, L3 per
    attention layer and decode step, L4 / L5 per recurrent layer in
    prefill; nothing else. The audio family's decoder layers attend
    twice (self and cross) in prefill and in every decode step, and its
    encoder layers once in prefill."""
    counts = {name: 0 for name in [*_wrappers(), *SM90]}
    n_attn, n_enc = _attention_calls(cfg)
    counts["flash_attention"] = n_attn + n_enc
    counts["flash_attention_sm90"] = n_attn + n_enc
    counts["decode_attention"] = n_attn * n_steps
    if cfg.family == "hybrid":
        counts["ssd_chunk"] = cfg.n_layers
    if cfg.family == "ssm":
        counts["wkv6"] = cfg.n_layers
    return counts


def _tensor_bytes(tree):
    import torch
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def phase_serve(dev, arch, tag, n_layers=None, past=0):
    """One model at full width (and full depth, or ``n_layers``): prefill
    of 8 x 4,000 positions into a 4,096-position context (a vlm prompt:
    its image positions, then text; an audio prompt: 4,000 text tokens
    over its 1,500 frames), 96 teacher-forced decode steps and ``past``
    more beyond the context (a ring cache wraps), exact launch counts, and
    the logits of 2 sequences against the port's forward over all
    positions through the plain kernel versions; for the moe family that
    forward calls the MoE layers on the tokens as the serve path does
    (``_serve_grouped_moe``), and an untimed second run records the kept
    experts, the drops and the ties (``_moe_replay``). The audio family's
    decode adds no position to the token, as the reference's does not, so
    it is not its forward: it is held against the serve path itself
    replayed through the plain kernel versions (``_serve_replay``)."""
    import torch
    from contextlib import ExitStack
    from unittest import mock
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunked
    from repro_torch.kernels.wkv6.ref import wkv_chunked
    from repro_torch.models import layers as LY
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import model as LM
    from repro_torch.models import moe as MOE
    from repro_torch.models import rwkv6 as R6
    from repro_torch.models import steps as ST
    cfg = get_config(arch)
    if n_layers:
        full = cfg
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        log(f"[{tag}] depth cut to {n_layers} of {full.n_layers} layers at "
            f"full width: the whole model's {full.param_count()} parameters "
            f"take {2 * full.param_count() / 1e9:.1f} GB in bf16, more than "
            f"the card's 80 GB")
    t0 = time.time()
    params = LM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    t1 = time.time()
    # a vlm prompt's first n_img positions are its image embeddings
    n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
    end = LLM_CONTEXT + past
    batch = next(synthetic_token_batches(cfg, LLM_BATCH, end - n_img,
                                         seed=0, device=dev))
    tokens = batch.pop("tokens")
    prompt = LLM_PROMPT - n_img
    active = (f" ({cfg.active_param_count()} active per token)"
              if cfg.is_moe else "")
    log(f"[{tag}] {_describe(cfg)}; {n_params} parameters{active}, "
        f"{w_bytes / 1e9:.2f} GB of weights made in {t1 - t0:.1f}s; tokens "
        f"{tuple(tokens.shape)}"
        + "".join(f", {k} {tuple(v.shape)}" for k, v in batch.items())
        + f" in {time.time() - t1:.1f}s")

    prefill_step = ST.make_prefill_step(
        cfg, InputShape("serve_4k", LLM_CONTEXT, LLM_BATCH, "prefill"))
    serve_step = ST.make_serve_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    logits, cache = prefill_step(params, {"tokens": tokens[:, :prompt],
                                          **batch})
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    cache_bytes = _tensor_bytes(cache)
    kept = [logits[:LLM_CHECK, 0].clone()]
    finite = torch.isfinite(logits).all()
    t0 = time.time()
    for t in range(prompt, end - n_img):
        logits, cache = serve_step(params, cache, tokens[:, t:t + 1])
        finite &= torch.isfinite(logits).all()
        kept.append(logits[:LLM_CHECK, 0].clone())
    torch.cuda.synchronize()
    decode_s = time.time() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_steps = end - LLM_PROMPT
    log(f"[{tag}-serve] prefill {LLM_BATCH} x {LLM_PROMPT} positions: "
        f"{prefill_s:.3f}s, {LLM_BATCH * LLM_PROMPT / prefill_s:.4g} "
        f"tokens/s; decode {n_steps} steps: {decode_s:.3f}s, "
        f"{1e3 * decode_s / n_steps:.3f} ms/step, "
        f"{LLM_BATCH * n_steps / decode_s:.4g} tokens/s"
        + (f" ({past} past the {LLM_CONTEXT}-slot ring)" if past else "")
        + f"; cache {cache_bytes / 1e9:.2f} GB; peak device memory "
        f"{peak / 1e9:.2f} GB; launches {counts}")
    assert bool(finite), f"{arch}: non-finite logits on the serve path"
    assert cache["pos"] == end
    if past:
        assert cache["attn"]["k"].shape[2] == LLM_CONTEXT, \
            f"{arch}: the cache is not a {LLM_CONTEXT}-slot ring"
    want = _expected_launches(cfg, n_steps)
    assert counts == want, f"{arch}: launches {counts}, expected {want}"
    assert peak < 80e9, f"{arch}: peak device memory {peak / 1e9:.2f} GB"
    # the profiled steps re-run the last decode steps: the recurrent state
    # moves on, and nothing reads it afterwards
    profile_decode(serve_step, params, cache, tokens, tag, end, offset=n_img)
    del cache, logits
    torch.cuda.empty_cache()
    replay = (_moe_replay(prefill_step, serve_step, params, cfg, tokens,
                          batch, prompt, tag) if cfg.is_moe else None)

    def plain_attention(q, k, v, causal=True, window=0):
        return flash_attention_ref(q, k, v, causal=causal,
                                   window=window).to(q.dtype)

    def plain_decode(q, k, v, kv_pos, q_pos, window=0):
        return decode_attention_ref(q, k, v, kv_pos, q_pos,
                                    window).to(q.dtype)

    # the reference: the port's forward over all positions (the audio
    # family: its serve path) with the plain kernel versions, in bf16 as
    # served, and in f32 on the same (bf16) weights, which shows how far
    # bf16 rounding alone moves the logits
    what = ("the serve path replayed through the plain kernels"
            if cfg.is_encdec else "the plain forward")
    kind = "replay" if cfg.is_encdec else "forward"
    V = cfg.vocab_size
    got = torch.stack(kept, dim=1)[..., :V]
    refs, ref_keeps = {}, []
    t0 = time.time()
    check = {"tokens": tokens[:LLM_CHECK],
             **{k: v[:LLM_CHECK] for k, v in batch.items()}}
    with ExitStack() as stack:
        for mod, name, fn in ((LY, "flash_attention", plain_attention),
                              (LY, "decode_attention", plain_decode),
                              (M2, "ssd_scan", ssd_chunked),
                              (R6, "wkv6", wkv_chunked),
                              (MOE, "moe_apply", _serve_grouped_moe(
                                  MOE.moe_apply, LLM_PROMPT)),
                              (MOE, "dispatch", _dispatch_keeps(
                                  MOE.dispatch, ref_keeps))):
            stack.enter_context(mock.patch.object(mod, name, fn))
        for name, c in (("bf16", cfg),
                        ("f32", dataclasses.replace(cfg, dtype="float32"))):
            if cfg.is_encdec:
                full = _serve_replay(params, c, check, prompt)
                refs[name] = full[..., :V].clone()
            else:
                full, _ = LM.forward(params, c, check)
                refs[name] = full[:, LLM_PROMPT - 1:, :V].clone()
            del full
            torch.cuda.empty_cache()
            if name == "bf16" and cfg.is_moe:
                ref_keep = _keeps_of(ref_keeps, cfg.n_layers, 1 + n_steps,
                                     layer_major=True)

    ratio, per_step, agree, rms = _logit_gap(got, refs["bf16"], V)
    r_k32, _, a_k32, _ = _logit_gap(got, refs["f32"], V)
    r_p32, _, a_p32, _ = _logit_gap(refs["bf16"], refs["f32"], V)
    median = float(per_step[1:].median())
    wrap = float(per_step[-past:].median()) if past else 0.0
    log(f"[{tag}-serve] vs {what} over {end} positions "
        f"({LLM_CHECK} sequences, {time.time() - t0:.1f}s): max |d logit| / "
        f"rms(logits) {ratio:.4g} (rms {rms:.4g}; "
        + (f"limit {LOGIT_TOL[arch]}" if replay is None
           else "routing flips included: LOGIT_TOL holds the rest, below")
        + "); "
        f"prefill step {float(per_step[0]):.4g}, decode steps max "
        f"{float(per_step[1:].max()):.4g} median {median:.4g} (limit "
        f"{LOGIT_MEDIAN_TOL[arch]})"
        + (f", median of the {past} past the ring {wrap:.4g}" if past else "")
        + f"; argmax agreement {agree:.4f}. "
        f"Against the f32 {kind}: serve path {r_k32:.4g} (argmax "
        f"{a_k32:.4f}; limit {F32_GAP_TOL} x the plain bf16 {kind}'s), "
        f"plain bf16 {kind} {r_p32:.4g} (argmax {a_p32:.4f})")
    if replay is not None:
        # a (sequence, step) at which the replay kept another expert set
        # for the token than the reference did, at any layer, moves by
        # that flip alone: LOGIT_TOL holds the others
        r_logits, r_keep = replay
        flip = (r_keep != ref_keep).any(dim=3).any(dim=0)
        r_gap = (r_logits[..., :V] - refs["bf16"]).abs().amax(dim=2) / rms
        steady = float(r_gap[~flip].max()) if (~flip).any() else 0.0
        log(f"[{tag}-serve] routing flips against the plain forward at "
            f"{int(flip.sum())} of {flip.numel()} checked (sequence, step) "
            f"pairs; the untimed replay's max |d logit| / rms over the "
            f"pairs without one {steady:.4g} (limit {LOGIT_TOL[arch]}), with "
            f"one {float(r_gap[flip].max()) if flip.any() else 0.0:.4g}; "
            f"replay vs the timed run max |d logit| / rms "
            f"{float((r_logits[..., :V] - got).abs().max()) / rms:.4g}")
        ratio = steady
    assert ratio <= LOGIT_TOL[arch], \
        f"{arch}: serve path disagrees with {what}"
    assert median <= LOGIT_MEDIAN_TOL[arch], \
        f"{arch}: serve path's decode steps move off {what}"
    assert wrap <= LOGIT_MEDIAN_TOL[arch], \
        f"{arch}: serve path moves off {what} past the ring"
    assert r_k32 <= F32_GAP_TOL * r_p32, \
        f"{arch}: serve path is farther from the f32 forward than bf16 rounding"
    del params, refs, got, kept
    torch.cuda.empty_cache()
    return counts


def _logit_gap(a, b, V):
    """(max over rows and steps of max |a - b| / rms(b), the per-step
    ratios, argmax agreement, rms(b)) of f32 logits (B, steps, ·) over
    the real vocabulary, the first V."""
    a, b = a[..., :V], b[..., :V]
    rms = float(b.square().mean().sqrt())
    per_step = (a - b).abs().amax(dim=(0, 2)) / rms
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    return float(per_step.max()), per_step, agree, rms


def _check_launches(tag, counts, want):
    """The run's launch counts must be exactly ``want`` (the named kernels;
    every other kernel 0)."""
    full = {name: 0 for name in counts}
    full.update(want)
    assert counts == full, f"[{tag}] launches {counts}, expected {full}"


def phase_serving_shapes(dev):
    """The reference's serving shapes on Qwen3-4B at full width and depth
    with seeded random bf16 weights: [shape-prefill32k], [int8-decode] and
    [long-context] (see SHAPE_SEQ's comment for each one's cuts). Returns
    the launch counts of each phase's runs, by path."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as LM
    cfg = get_config(LLM_ARCH)
    t0 = time.time()
    params = LM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    torch.cuda.synchronize()
    log(f"[serving-shapes] {_describe(cfg)}; weights made in "
        f"{time.time() - t0:.1f}s")
    counts = {"serve_prefill32k": phase_shape_prefill32k(dev, params, cfg)}
    counts.update(phase_int8_decode(dev, params, cfg))
    counts.update(phase_long_context(dev, params, cfg))
    del params
    torch.cuda.empty_cache()
    return counts


def _peak_reset():
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()


def phase_shape_prefill32k(dev, params, cfg):
    """prefill_32k through ``make_prefill_step``: one 32,768-token prompt
    (the shape's batch of 32 cut to 1) into its 32,768-slot cache, L1 at
    the shape's length; then the gate: the prefill of S + 1 tokens (L1;
    the shape's cache keeps their last S positions) against the prefill of
    S tokens into an (S + 1)-slot cache plus one ``decode_step`` of token
    S (L3), the same last-token function by two routes. (A decode step
    into the full S-slot cache would overwrite its last slot, as the
    reference's clamped write does.)"""
    import torch
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.models import steps as ST
    tag = "shape-prefill32k"
    shape = INPUT_SHAPES["prefill_32k"]
    S = shape.seq_len
    assert S == SHAPE_SEQ
    tokens = next(synthetic_token_batches(cfg, 1, S + 1, seed=1,
                                          device=dev))["tokens"]
    prefill_step = ST.make_prefill_step(cfg, shape)
    serve_step = ST.make_serve_step(cfg)
    _peak_reset()
    t0 = time.time()
    logits, cache = prefill_step(params, {"tokens": tokens[:, :S]})
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    timed = read_counts()
    cache_bytes = _tensor_bytes(cache)
    del cache, logits
    torch.cuda.empty_cache()
    longer, cache = prefill_step(params, {"tokens": tokens})
    assert cache["pos"] == S + 1 and int(cache["attn"]["kv_pos"][0].max()) \
        == S and int(cache["attn"]["kv_pos"][0].min()) == 1
    del cache
    torch.cuda.empty_cache()
    roomy = ST.make_prefill_step(cfg, dataclasses.replace(
        shape, name="prefill_32k_plus_one", seq_len=S + 1))
    _, cache = roomy(params, {"tokens": tokens[:, :S]})
    step, cache = serve_step(params, cache, tokens[:, S:S + 1])
    counts = read_counts()
    del cache
    torch.cuda.empty_cache()
    gap, _, agree, _ = _logit_gap(step, longer, cfg.vocab_size)
    log(f"[{tag}] prefill_32k cut to batch 1 (of {shape.global_batch}): "
        f"prefill 1 x {S} tokens {prefill_s:.3f}s, {S / prefill_s:.4g} "
        f"tokens/s; cache {cache_bytes / 1e9:.2f} GB; peak device memory "
        f"{peak / 1e9:.2f} GB; L1 {timed['flash_attention']} launches "
        f"(sm90 {timed['flash_attention_sm90']}); prefill of {S + 1} "
        f"tokens vs prefill of {S} into {S + 1} slots + one decode step: "
        f"max |d logit| / rms "
        f"{gap:.4g} (limit {PREFILL32K_LOGIT_TOL}), argmax "
        f"{'same' if agree == 1.0 else 'differs'}; phase launches {counts}")
    n = cfg.n_layers
    _check_launches(tag, timed, {"flash_attention": n,
                                 "flash_attention_sm90": n})
    _check_launches(tag, counts, {"flash_attention": 3 * n,
                                  "flash_attention_sm90": 3 * n,
                                  "decode_attention": n})
    assert bool(torch.isfinite(step).all() & torch.isfinite(longer).all())
    assert gap <= PREFILL32K_LOGIT_TOL, f"[{tag}] the two routes disagree"
    assert peak < 80e9
    return counts


def phase_int8_decode(dev, params, cfg):
    """decode_32k's cache length at batch INT8_BATCH: INT8_PROMPT tokens
    decoded from the empty int8 cache, then INT8_STEPS teacher-forced
    steps; the same tokens through the bf16 cache (L3 over 32,768 slots).
    Gates: the int8 logits against the bf16 ones (max and median step),
    each cache's bytes equal to its spec tree on ``meta``, and launches:
    none in the int8 run (its attention is plain, as the reference routes
    an int8 cache), L3 per layer and step in the bf16 run."""
    import torch
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.models import kvcache as KV
    from repro_torch.models import steps as ST
    tag = "int8-decode"
    shape = dataclasses.replace(INPUT_SHAPES["decode_32k"],
                                global_batch=INT8_BATCH)
    n_tok = INT8_PROMPT + INT8_STEPS
    tokens = next(synthetic_token_batches(cfg, INT8_BATCH, n_tok, seed=2,
                                          device=dev))["tokens"]
    serve_step = ST.make_serve_step(cfg)
    runs = {}
    for quant in (True, False):
        name = "int8" if quant else "bf16"
        _peak_reset()
        cache = KV.serve_cache_init(cfg, INT8_BATCH, shape.seq_len,
                                    device=dev, kv_quant=quant)
        spec = (ST.cache_specs_quant if quant else ST.cache_specs)(cfg, shape)
        cache_bytes = _tensor_bytes(cache)
        assert cache_bytes == _tensor_bytes(spec), \
            f"[{tag}] {name} cache {cache_bytes} bytes, spec " \
            f"{_tensor_bytes(spec)}"
        assert {k: (v.shape, v.dtype) for k, v in cache["attn"].items()} == \
            {k: (v.shape, v.dtype) for k, v in spec["attn"].items()}
        kept = []
        torch.cuda.synchronize()
        t0 = time.time()
        for t in range(n_tok):
            if t == INT8_PROMPT:
                torch.cuda.synchronize()
                t1 = time.time()
            logits, cache = serve_step(params, cache, tokens[:, t:t + 1])
            kept.append(logits[:, 0])
        torch.cuda.synchronize()
        t2 = time.time()
        runs[name] = dict(
            logits=torch.stack(kept, dim=1), bytes=cache_bytes,
            peak=torch.cuda.max_memory_allocated(), counts=read_counts(),
            prompt_ms=1e3 * (t1 - t0) / INT8_PROMPT,
            step_ms=1e3 * (t2 - t1) / INT8_STEPS)
        assert cache["pos"] == n_tok
        if quant:
            # the plain route's host cost: kernels a step and busy share
            # (after the counts: the profiled step reruns the last one)
            profile_decode(serve_step, params, cache, tokens, f"{tag}-int8",
                           n_tok, n=1)
        del cache, kept, logits
    i8, bf = runs["int8"], runs["bf16"]
    gap, per_step, agree, _ = _logit_gap(i8["logits"], bf["logits"],
                                         cfg.vocab_size)
    median = float(per_step.median())
    finite = bool(torch.isfinite(i8["logits"]).all()
                  & torch.isfinite(bf["logits"]).all())
    for name, r in runs.items():
        log(f"[{tag}] {name} cache of {shape.seq_len} slots x "
            f"{INT8_BATCH} rows (decode_32k's batch of "
            f"{INPUT_SHAPES['decode_32k'].global_batch} cut to "
            f"{INT8_BATCH}): {r['bytes'] / 1e9:.2f} GB (= its spec on meta); "
            f"prompt of {INT8_PROMPT} tokens by decode_step "
            f"{r['prompt_ms']:.2f} ms/step, then {INT8_STEPS} steps "
            f"{r['step_ms']:.2f} ms/step, {INT8_BATCH * 1e3 / r['step_ms']:.4g}"
            f" tokens/s; peak device memory {r['peak'] / 1e9:.2f} GB; "
            f"launches {r['counts']}")
    log(f"[{tag}] int8 vs bf16 cache over {n_tok} steps: max |d logit| / "
        f"rms {gap:.4g} (limit {INT8_LOGIT_TOL}), median step {median:.4g} "
        f"(limit {INT8_LOGIT_MEDIAN_TOL}), last step {float(per_step[-1]):.4g}"
        f"; argmax agreement {agree:.4f}")
    n = cfg.n_layers
    _check_launches(tag, i8["counts"], {})
    _check_launches(tag, bf["counts"], {"decode_attention": n * n_tok})
    assert finite, f"[{tag}] non-finite logits"
    assert gap <= INT8_LOGIT_TOL and median <= INT8_LOGIT_MEDIAN_TOL, \
        f"[{tag}] the int8 cache moves the logits off the bf16 cache's"
    assert max(i8["peak"], bf["peak"]) < 80e9
    return {"serve_int8_decode": i8["counts"],
            "serve_int8_decode_bf16": bf["counts"]}


def phase_long_context(dev, params, cfg):
    """long_500k as the reference runs a full-attention dense model:
    ``make_prefill_step`` with ``long_context_window``'s override (an
    8,192-slot ring) over a LONG_PROMPT-token prompt, which attends with
    full causal attention and keeps its last 8,192 positions at
    ring-aligned slots; LONG_STEPS decode steps through
    ``make_serve_step`` with the window, which overwrite the oldest slots.
    Gate: the same prompt and steps through a LONG_PROMPT + LONG_STEPS
    slot cache decoded with the same window mask (no ring)."""
    import torch
    from repro_torch.configs.base import INPUT_SHAPES, InputShape
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.models import model as LM
    from repro_torch.models import steps as ST
    tag = "long-context"
    shape = INPUT_SHAPES["long_500k"]
    window = ST.long_context_window(cfg, shape)
    end = LONG_PROMPT + LONG_STEPS
    tokens = next(synthetic_token_batches(cfg, 1, end, seed=3,
                                          device=dev))["tokens"]
    unringed = InputShape("long_500k_unringed", end, 1, "decode")
    runs = {}
    for name, pshape, override in (("ring", shape, window),
                                   ("unringed", unringed, None)):
        prefill_step = ST.make_prefill_step(cfg, pshape, override)
        serve_step = ST.make_serve_step(cfg, window)
        _peak_reset()
        t0 = time.time()
        logits, cache = prefill_step(params,
                                     {"tokens": tokens[:, :LONG_PROMPT]})
        torch.cuda.synchronize()
        prefill_s = time.time() - t0
        slots = cache["attn"]["k"].shape[2]
        kv_pos = cache["attn"]["kv_pos"][0]
        kept_pos = (int(kv_pos[kv_pos >= 0].min()), int(kv_pos.max()))
        kept = [logits[:, 0]]
        t0 = time.time()
        for t in range(LONG_PROMPT, end):
            logits, cache = serve_step(params, cache, tokens[:, t:t + 1])
            kept.append(logits[:, 0])
        torch.cuda.synchronize()
        runs[name] = dict(
            logits=torch.stack(kept, dim=1), slots=slots, kept=kept_pos,
            prefill_s=prefill_s,
            step_ms=1e3 * (time.time() - t0) / LONG_STEPS,
            peak=torch.cuda.max_memory_allocated(), counts=read_counts(),
            end_pos=(int(cache["attn"]["kv_pos"][0].min()),
                     int(cache["attn"]["kv_pos"][0].max())))
        del cache, logits, kept
    ring, ref = runs["ring"], runs["unringed"]
    gap, per_step, agree, _ = _logit_gap(ring["logits"], ref["logits"],
                                         cfg.vocab_size)
    for name, r in runs.items():
        log(f"[{tag}] {name}: {r['slots']} slots at batch 1, prefill of "
            f"{LONG_PROMPT} tokens {r['prefill_s']:.3f}s (kept positions "
            f"{r['kept'][0]}-{r['kept'][1]}), {LONG_STEPS} decode steps with "
            f"window {window} {r['step_ms']:.2f} ms/step (positions "
            f"{r['end_pos'][0]}-{r['end_pos'][1]} in the cache after them); "
            f"peak device memory {r['peak'] / 1e9:.2f} GB; launches "
            f"{r['counts']}")
    log(f"[{tag}] long_500k cut: the decode reaches position {end - 1}, "
        f"not {shape.seq_len - 1} (the ring arithmetic is the same past any "
        f"multiple of the window); ring vs unringed over the prefill and "
        f"{LONG_STEPS} steps: max |d logit| / rms {gap:.4g} (limit "
        f"{LONG_LOGIT_TOL}; the prefill step {float(per_step[0]):.4g}, "
        f"which must be 0), argmax agreement {agree:.4f}")
    assert window == LM.LONG_CONTEXT_WINDOW and ring["slots"] == window
    assert ring["kept"] == (LONG_PROMPT - window, LONG_PROMPT - 1)
    assert ring["end_pos"] == (end - window, end - 1)
    assert ref["slots"] == end and ref["kept"] == (0, LONG_PROMPT - 1)
    n = cfg.n_layers
    for r in runs.values():
        _check_launches(tag, r["counts"], {
            "flash_attention": n, "flash_attention_sm90": n,
            "decode_attention": n * LONG_STEPS})
    assert bool(torch.isfinite(ring["logits"]).all())
    # the prefill attends alike whatever the cache's size
    assert float(per_step[0]) == 0.0, f"[{tag}] the override moved prefill"
    assert gap <= LONG_LOGIT_TOL, f"[{tag}] the ring moves off the window mask"
    return {"serve_long_context": ring["counts"],
            "serve_long_context_unringed": ref["counts"]}


def _serve_replay(params, cfg, batch, prompt):
    """The serve path's logits for ``batch`` (its rows): prefill of the
    first ``prompt`` tokens into a fresh LLM_CONTEXT-slot cache in
    ``cfg``'s compute dtype, then one teacher-forced decode step per later
    token; (rows, 1 + steps, Vp). Run under the plain kernel versions, it
    is the audio family's reference (its decode is not its forward)."""
    import torch
    from repro_torch.models import kvcache as KV
    from repro_torch.models import model as LM
    tokens = batch["tokens"]
    cache = KV.serve_cache_init(cfg, tokens.shape[0], LLM_CONTEXT,
                                dtype=LM.compute_dtype(cfg),
                                device=tokens.device)
    logits, cache = LM.prefill(params, cfg,
                               dict(batch, tokens=tokens[:, :prompt]), cache)
    out = [logits[:, 0]]
    for t in range(prompt, tokens.shape[1]):
        logits, cache = LM.decode_step(params, cfg, cache,
                                       tokens[:, t:t + 1])
        out.append(logits[:, 0])
    return torch.stack(out, dim=1)


def _serve_grouped_moe(moe_apply, prompt):
    """``moe_apply`` over a forward's (B, S, d) in the calls the serve path
    makes: the first ``prompt`` positions in one call, as prefill makes
    it, then one call per later position, as each decode step makes it,
    so that ``moe_apply`` groups them (and drops from them) as it does
    there. The aux values are the prompt call's."""
    import torch

    def grouped(params, cfg, x):
        y, aux = moe_apply(params, cfg, x[:, :prompt])
        steps = [moe_apply(params, cfg, x[:, t:t + 1])[0]
                 for t in range(prompt, x.shape[1])]
        return torch.cat([y, *steps], dim=1), aux

    return grouped


def _dispatch_keeps(dispatch, calls, rows=None):
    """``moe.dispatch`` that also appends, for each call, the (token,
    expert) pairs it kept at its last position for its first ``rows``
    rows (all by default), (rows, E), its ``moe_dropped`` and its number
    of tokens kept by more than K experts (router ties, ``moe.route``) to
    ``calls``."""
    from repro_torch.models import moe as MOE

    def recorded(router, cfg, x, experts=None):
        e_in, disp = dispatch(router, cfg, x, experts)
        B, S0 = x.shape[:2]
        K = cfg.experts_per_token
        calls.append((disp.keep.reshape(B, S0, -1)[:rows, -1].clone(),
                      MOE.load_balance(disp, K)[2],
                      (disp.mask.sum(-1) > K).sum()))
        return e_in, disp
    return recorded


def _keeps_of(calls, n_layers, n_steps, per_layer=1, pick=(0,),
              layer_major=False):
    """(n_layers, rows, n_steps, E) from ``_dispatch_keeps``'s calls,
    ``per_layer`` calls a layer (one per slot of a mesh), made step by
    step, layer by layer (the serve path), or with ``layer_major`` layer
    by layer, step by step (a forward that calls each layer once per
    step, ``_serve_grouped_moe``): the rows of the calls at ``pick`` (the
    model axis's first slot of each data row), in order."""
    import torch

    def at(li, t, j):
        i = (li * n_steps + t if layer_major else t * n_layers + li)
        return calls[i * per_layer + j][0]

    assert len(calls) == n_steps * n_layers * per_layer, len(calls)
    return torch.stack([torch.stack([torch.cat([at(li, t, j) for j in pick])
                                     for t in range(n_steps)], dim=1)
                        for li in range(n_layers)])


def _moe_replay(prefill_step, serve_step, params, cfg, tokens, batch,
                prompt, tag):
    """An untimed second run of the serve path, prefill and every decode
    step, that records each MoE layer's kept pairs for the checked
    sequences (``_dispatch_keeps``): returns their logits (LLM_CHECK,
    1 + steps, Vp) and kept pairs (L, LLM_CHECK, 1 + steps, E). Prints the
    prefill's ``moe_dropped`` and the tokens whose bf16 router
    probabilities tie at the K-th largest, so that they keep more than K
    experts, per layer."""
    import torch
    from unittest import mock
    from repro_torch.models import moe as MOE
    calls, kept = [], []
    with mock.patch.object(MOE, "dispatch",
                           _dispatch_keeps(MOE.dispatch, calls, LLM_CHECK)):
        logits, cache = prefill_step(params, {"tokens": tokens[:, :prompt],
                                              **batch})
        kept.append(logits[:LLM_CHECK, 0])
        for t in range(prompt, tokens.shape[1]):
            logits, cache = serve_step(params, cache, tokens[:, t:t + 1])
            kept.append(logits[:LLM_CHECK, 0])
    del cache
    L, n_steps = cfg.n_layers, tokens.shape[1] - prompt
    d = torch.stack([c[1] for c in calls[:L]]).float().cpu()
    o = torch.stack([c[2] for c in calls[:L]]).cpu()
    G, S, C = MOE.groups_and_capacity(cfg, LLM_BATCH, LLM_PROMPT)
    log(f"[{tag}-moe] prefill of {LLM_BATCH} x {LLM_PROMPT} tokens in {G} "
        f"groups of {S}, capacity {C} per expert and group: moe_dropped "
        f"mean over layers {float(d.mean()):.5f} (min {float(d.min()):.5f}, "
        f"max {float(d.max()):.5f}); tokens keeping more than "
        f"{cfg.experts_per_token} experts (router ties) {int(o.sum())} over "
        f"{len(o)} layers (max {int(o.max())} in one layer, of "
        f"{LLM_BATCH * LLM_PROMPT} tokens)")
    keeps = _keeps_of(calls, L, 1 + n_steps)
    torch.cuda.empty_cache()
    return torch.stack(kept, dim=1), keeps


def device_profile():
    """``torch.profiler`` over the device's activity only: ``device_time``
    reads nothing else, and the host ops' events cost the post-processing
    of every profiled window seconds (on the H100 with both, a profiled
    train step took 10-18 s beside 0.7-1.6 s unprofiled; PERF.md)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def device_time(prof, check=False):
    """({kernel name: (device us, count)}, busy ms) of a ``torch.profiler``
    run: busy is the union of the device activities' intervals, so that
    work on overlapping streams is counted once and the busy share of the
    wall cannot pass 100%. Read from the profiler's raw kineto events:
    ``prof.events()`` builds a Python event tree first, which cost the
    sharded train steps' profiled windows (~40,000-150,000 kernels) tens
    of seconds of host time on the H100's machine. With ``check``, the
    same window is read from ``prof.events()`` too (the tree this
    reading replaced), and the two readings must agree."""
    import torch
    kernels, spans = {}, []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        us, n = kernels.get(ev.name(), (0.0, 0))
        kernels[ev.name()] = (us + ev.duration_ns() / 1e3, n + 1)
        spans.append((ev.start_ns(), ev.end_ns()))
    # in integer ns: absolute timestamps in float µs keep ~0.25 µs
    busy = _union(spans) / 1e6
    if check:
        t0 = time.time()
        tree = [ev for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA]
        t_busy = _union([(ev.time_range.start, ev.time_range.end)
                         for ev in tree]) / 1e3
        t_us = sum(ev.time_range.elapsed_us() for ev in tree)
        k_us = sum(us for us, _ in kernels.values())
        n = sum(c for _, c in kernels.values())
        log(f"[device-time] one window read both ways: raw kineto events "
            f"{n} device activities, {k_us:.1f} us, busy {busy:.4f} ms; "
            f"prof.events() {len(tree)}, {t_us:.1f} us, busy {t_busy:.4f} "
            f"ms (its tree took {time.time() - t0:.1f}s)")
        assert len(tree) == n, "device activities differ by reading"
        assert abs(t_us - k_us) <= 1e-6 * k_us + 1e-3, "device time"
        assert abs(t_busy - busy) <= 1e-6 * busy + 1e-6, "busy time"
    return kernels, busy


def _union(spans):
    """The length of the union of the (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def profile_decode(serve_step, params, cache, tokens, tag, end, n=3,
                   offset=0):
    """Re-run the last ``n`` decode steps, up to position ``end`` (the
    cache is rewound; the same tokens rewrite the same slots) under
    ``torch.profiler``: device time by kernel and the device's busy share
    of the wall. ``offset``: the positions before the first token (a vlm
    prompt's image)."""
    import torch
    start = end - n
    cache["pos"] = start
    torch.cuda.synchronize()
    with device_profile() as prof:
        t0 = time.time()
        for t in range(start - offset, end - offset):
            serve_step(params, cache, tokens[:, t:t + 1])
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels, busy = device_time(prof)
    if not kernels:
        log(f"[{tag}-profile] the profiler recorded no device time: device "
            "busy share not measured")
        return
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"[{tag}-profile] {n} decode steps under the profiler: wall "
        f"{1e3 * wall / n:.3f} ms/step, device busy {busy / n:.3f} ms/step "
        f"({100 * busy / (1e3 * wall):.1f}% of the wall), "
        f"{sum(c for _, c in kernels.values()) // n} kernels/step; top: "
        + "; ".join(f"{k[:60]} {us / 1e3 / n:.3f} ms x{c // n}"
                    for k, (us, c) in top))


def _sdpa_bwd_ms(q, k, v, do, reps, **kw):
    """The library yardstick for L2: the backward of one
    ``scaled_dot_product_attention`` call on (B, H, S, hd) views of the
    same tensors, K/V repeated to the query heads before the timing (timed
    here only; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    group = q.shape[-2] // k.shape[-2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (t.repeat_interleave(group, dim=2).transpose(1, 2).detach()
              .requires_grad_() for t in (k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    dout = do.transpose(1, 2)
    ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dout,
                                             retain_graph=True), reps)
    del out, qt, kt, vt
    return ms


def _limit(tol, scale, dtype):
    """The allowed max |error|: ``tol`` bf16 steps of the largest plain
    value in bf16, ``tol`` x that value in fp32."""
    if dtype == "bf16":
        return tol * 2.0 ** (math.floor(math.log2(scale)) - 7)
    return tol * scale


def _rel_err(got, want):
    """(max |got - want|, max(|want|, 1)) of the worst of several outputs,
    by the ratio of the two."""
    worst = (0.0, 1.0)
    for a, b in zip(got, want):
        err = float((a.float() - b.float()).abs().max())
        scale = max(float(b.float().abs().max()), 1.0)
        if err / scale >= worst[0] / worst[1]:
            worst = (err, scale)
    return worst


def _l2_case(g, dev, case, B, S, H, Hkv, hd, causal, window, dtype,
             tag="l2-parity", Skv=None):
    """L1's lse against the plain logsumexp, then L2 against its plain
    version on the same (q, k, v, o, do, lse), compared on the first
    L2_CHECK sequences, timed at the full batch beside the plain version,
    the bound and SDPA's backward; S queries over ``Skv`` keys (by
    default S)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as L1
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         flash_attention_ref,
                                                         flash_bwd_ref)
    Skv, C = Skv or S, L2_CHECK
    mask = attention_mask(S, Skv, causal, window, dev)
    pairs = int(mask.sum())
    q, do = (torch.randn((B, S, H, hd), generator=g, device=dev)
             .to(_tdt(dtype)) for _ in range(2))
    k, v = (torch.randn((B, Skv, Hkv, hd), generator=g, device=dev)
            .to(_tdt(dtype)) for _ in range(2))
    o, lse = L1.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True)
    _, lse_p = flash_attention_ref(q[:C], k[:C], v[:C], causal=causal,
                                   window=window, return_lse=True)
    lse_err = float((lse[:C] - lse_p).abs().max())
    lse_scale = max(float(lse_p.abs().max()), 1.0)
    del lse_p
    ok = lse_err <= LSE_TOL * lse_scale
    log(f"[{tag}] L1 lse {case} {dtype}: max_abs_err {lse_err:.3e} "
        f"(tolerance {LSE_TOL:.0e} x {lse_scale:.3g} = "
        f"{LSE_TOL * lse_scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"L1 lse {case} {dtype} disagrees with the "
                             "plain logsumexp")

    def kern():
        return L1.flash_bwd(q, k, v, o, do, lse, causal=causal,
                            window=window)

    def plain():
        return [flash_bwd_ref(q[b:b + C], k[b:b + C], v[b:b + C],
                              o[b:b + C], do[b:b + C], lse[b:b + C],
                              causal=causal, window=window)
                for b in range(0, B, C)]

    got = [t[:C] for t in kern()]
    want = [t.to(q.dtype) for t in flash_bwd_ref(
        q[:C], k[:C], v[:C], o[:C], do[:C], lse[:C], causal=causal,
        window=window)]
    err, scale = _rel_err(got, want)
    del got, want
    ms, pms = cuda_ms(kern, 3, warmup=1), cuda_ms(plain, 1, warmup=0)
    torch.cuda.empty_cache()
    if window:
        lib = _sdpa_bwd_ms(q, k, v, do, 3, attn_mask=mask)
    else:
        lib = _sdpa_bwd_ms(q, k, v, do, 3, is_causal=causal)
    torch.cuda.empty_cache()
    elt = q.element_size()
    # q, k, v, o, do, lse and D read once; dq, dk, dv written once; 10 hd
    # flops per unmasked pair and q-head (five products)
    n_bytes = (elt * (3 * q.numel() + 2 * k.numel()) + 2 * 4 * lse.numel()
               + elt * (q.numel() + 2 * k.numel()))
    bd, extra = _attn_bound(n_bytes, 10 * hd * H * B * pairs, dtype)
    tol = _limit(L2_TOL[dtype], scale, dtype) / scale
    del q, k, v, o, do, lse, mask
    torch.cuda.empty_cache()
    return _attn_line("flash_attention_bwd", case, dtype, err, scale, tol,
                      ms, pms, bd, lib, n_bytes, tag=tag, **extra)


def phase_l2_parity(dev):
    """L2 against its plain version, L1's lse, and the autograd Function,
    at the train path's attention shape."""
    import torch
    from repro_torch.configs.base import get_config
    cfg = get_config(LLM_ARCH)
    B, S = L2_BATCH, L2_SEQ
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(1)
    results = []
    for case, causal, window in (("causal-4096", True, 0),
                                 ("window1024-4096", True, 1024),
                                 ("noncausal-4096", False, 0)):
        for dtype in ("bf16", "fp32"):
            results.append(_l2_case(g, dev, case, B, S, H, Hkv, hd, causal,
                                    window, dtype))

    # end to end: L1 forward + L2 backward through the autograd Function
    # against autograd through the plain attention, one sequence, do fixed
    for dtype in ("bf16", "fp32"):
        _l2_e2e(g, dev, S, H, Hkv, hd, dtype, "causal-4096")
    return results


def _l2_e2e(g, dev, S, H, Hkv, hd, dtype, case, tag="l2-parity"):
    """The autograd Function (L1 + L2) against autograd through the plain
    attention on one causal sequence of S positions, do fixed, under
    E2E_TOL."""
    import torch
    from repro_torch.kernels.flash_attention import ops as L1
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q = torch.randn((1, S, H, hd), generator=g, device=dev).to(_tdt(dtype))
    k, v = (torch.randn((1, S, Hkv, hd), generator=g, device=dev)
            .to(_tdt(dtype)) for _ in range(2))
    do = torch.randn((1, S, H, hd), generator=g, device=dev)

    def grads(attend):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        (attend(qs, ks, vs).float() * do).sum().backward()
        return [t.grad for t in (qs, ks, vs)]

    got = grads(lambda a, b, c: L1.flash_attention_trainable(a, b, c))
    want = grads(lambda a, b, c: flash_attention_ref(a, b, c).to(a.dtype))
    err, scale = _rel_err(got, want)
    tol = _limit(E2E_TOL[dtype], scale, dtype) / scale
    ok = err <= tol * scale
    log(f"[{tag}] autograd Function (L1 + L2) vs autograd through the "
        f"plain attention, {case} {dtype}: max_abs_err {err:.3e} "
        f"(tolerance {tol:.3g} x {scale:.3g} = {tol * scale:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"autograd Function {case} {dtype} disagrees "
                             "with autograd through the plain attention")
    del q, k, v, do, got, want
    torch.cuda.empty_cache()


def _grad_stats(a, b):
    """(cosine of the flattened gradients a and b, |a| / |b| - 1), summed
    per tensor in f64."""
    dot = na = nb = 0.0
    for x, y in zip(a, b):
        x, y = x.double(), y.double()
        dot += float((x * y).sum())
        na += float((x * x).sum())
        nb += float((y * y).sum())
    return dot / (na * nb) ** 0.5, (na / nb) ** 0.5 - 1.0


def train_check(params, cfg, batch, tag="llm-train"):
    """The loss and gradients of ``loss_fn`` for one sequence (``batch``:
    its tokens and any frontend stub's embeddings), before any update:
    through the kernels (bf16, as trained), through the plain attention
    (bf16), and through the plain attention in f32 on the same weights,
    which shows how far bf16 rounding alone moves them. Fails if the
    kernels' pass is outside the TRAIN_* limits. A model without
    attention (the ssm family) trains through no kernel: its bf16 pass is
    held against the f32 pass under the SSM_TRAIN_* limits."""
    import torch
    from unittest import mock
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import layers as LY
    from repro_torch.models import steps as ST

    def plain(q, k, v, causal=True, window=0):
        return flash_attention_ref(q, k, v, causal=causal,
                                   window=window).to(q.dtype)

    def run(c, attend):
        with mock.patch.object(LY, "flash_attention_trainable", attend):
            loss, _ = ST.loss_fn(params, c, batch)
            loss.backward()
        grads = [p.grad for p in params.parameters()]
        for p in params.parameters():
            p.grad = None
        return float(loss.detach()), grads

    t0 = time.time()
    f32 = dataclasses.replace(cfg, dtype="float32")
    if not _attention_calls(cfg)[0]:
        bf16, ref = run(cfg, plain), run(f32, plain)
        torch.cuda.synchronize()
        cos, norm = _grad_stats(bf16[1], ref[1])
        gap = dict(loss=bf16[0] - ref[0], cos=1.0 - cos, norm=norm)
        log(f"[{tag}-check] one sequence of {batch['tokens'].shape[1]} "
            f"tokens, {time.time() - t0:.1f}s, no kernel on the path: loss "
            f"bf16 {bf16[0]:.6f}, f32 {ref[0]:.6f}; bf16 vs f32: d loss "
            f"{gap['loss']:.3e}, 1 - grad cosine {gap['cos']:.3e}, |g| "
            f"ratio - 1 {gap['norm']:.3e}; limits {SSM_TRAIN_LOSS_TOL}, "
            f"{SSM_TRAIN_COS_TOL}, {SSM_TRAIN_NORM_TOL}")
        assert abs(gap["loss"]) <= SSM_TRAIN_LOSS_TOL, "train loss: bf16"
        assert gap["cos"] <= SSM_TRAIN_COS_TOL, "gradients: bf16 vs f32"
        assert abs(gap["norm"]) <= SSM_TRAIN_NORM_TOL, "grad norm: bf16"
        return
    paths = {"kernels": run(cfg, LY.flash_attention_trainable),
             "plain": run(cfg, plain),
             "f32": run(f32, plain)}
    torch.cuda.synchronize()
    stats = {}
    for a, b in (("kernels", "plain"), ("kernels", "f32"), ("plain", "f32")):
        cos, norm = _grad_stats(paths[a][1], paths[b][1])
        stats[(a, b)] = dict(loss=paths[a][0] - paths[b][0], cos=cos,
                             norm=norm)
    log(f"[{tag}-check] one sequence of {batch['tokens'].shape[1]} tokens, "
        f"{time.time() - t0:.1f}s: loss kernels {paths['kernels'][0]:.6f}, "
        f"plain {paths['plain'][0]:.6f}, f32 {paths['f32'][0]:.6f}; "
        + "; ".join(f"{a} vs {b}: d loss {st['loss']:.3e}, grad cosine "
                    f"{st['cos']:.6f}, |g| ratio - 1 {st['norm']:.3e}"
                    for (a, b), st in stats.items())
        + f"; limits {TRAIN_LOSS_TOL}, 1 - cosine {TRAIN_COS_TOL}, "
        f"{TRAIN_NORM_TOL}, and the kernels' 1 - cosine to f32 at most "
        f"{F32_GAP_TOL} x the plain bf16 pass's")
    kp = stats[("kernels", "plain")]
    gap_k = 1.0 - stats[("kernels", "f32")]["cos"]
    gap_p = 1.0 - stats[("plain", "f32")]["cos"]
    assert abs(kp["loss"]) <= TRAIN_LOSS_TOL, "train loss: kernels vs plain"
    assert 1.0 - kp["cos"] <= TRAIN_COS_TOL, "gradients: kernels vs plain"
    assert abs(kp["norm"]) <= TRAIN_NORM_TOL, "grad norm: kernels vs plain"
    assert gap_k <= F32_GAP_TOL * gap_p, \
        "the kernels' gradients are farther from f32 than bf16 rounding"


def _train_flops(cfg, batch, seq):
    """Model FLOPs of one train step, without the remat recompute: 6 per
    parameter of every matrix product (the unembedding at the padded
    vocabulary; of a moe layer the router and the K routed experts, its
    active parameters) and token, plus attention's 12 hd per unmasked
    (query, key) pair and q-head (4 hd forward, 8 hd backward). The audio
    family's encoder layers and its cross K/V projections run on the
    n_audio_frames frames; its decoder attends causally to the text and
    to every frame. The recurrent families' scans count as their
    sequential recurrences do, 4 P N per step and head forward (the
    state update and the read, 2 P N each; rwkv6 P = N) and twice that
    backward; the hybrid family's shared block counts once per
    application."""
    d, hd, H = cfg.d_model, cfg.head_dim, cfg.n_heads
    qo, kv = 2 * d * H * hd, 2 * d * cfg.n_kv_heads * hd
    if cfg.is_moe:
        mlp = cfg.experts_per_token * 3 * d * cfg.d_ff + d * cfg.n_experts
    else:
        mlp = (2 if cfg.is_encdec else 3) * d * cfg.d_ff
    # matmul parameters by the rows they multiply, and the attended
    # (query, key) pairs of one sequence over all layers
    n_attn = cfg.n_layers
    per_token = d * cfg.padded_vocab_size
    if cfg.family == "hybrid":
        d_in = cfg.ssm_expand * d
        n_heads, P, N = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, \
            cfg.ssm_state
        n_attn = cfg.n_layers // cfg.shared_attn_period
        per_token += (cfg.n_layers * (3 * d * d_in + 2 * d * N + d * n_heads
                                      + 2 * n_heads * P * N)
                      + n_attn * (qo + kv + mlp))
    elif cfg.family == "ssm":
        n_attn = 0
        per_token += cfg.n_layers * (5 * d * d + 2 * 64 * d
                                     + 2 * d * cfg.d_ff
                                     + 2 * d * cfg.wkv_head_dim)
    else:
        per_token += cfg.n_layers * (qo + kv + mlp)
    pairs = n_attn * seq * (seq + 1) // 2
    F = per_frame = 0
    if cfg.is_encdec:
        F = cfg.n_audio_frames
        per_token += cfg.n_layers * qo             # cross-attention's q, o
        per_frame = (cfg.n_encoder_layers * (qo + kv + mlp)
                     + cfg.n_layers * kv)          # the encoder; cross K/V
        pairs += cfg.n_layers * seq * F + cfg.n_encoder_layers * F * F
    return (6 * batch * (per_token * seq + per_frame * F)
            + 12 * hd * H * pairs * batch)


def phase_llm_train(dev, arch=LLM_ARCH, n_layers=TRAIN_LAYERS,
                    tag="llm-train"):
    """``arch`` at full width, ``n_layers`` layers (Qwen3-4B: 8; Granite-
    MoE: all 24; zamba2-7b: 15; rwkv6-7b: 8): the one-sequence check, then
    TRAIN_STEPS train steps with remat and 2 microbatches, with exact
    launch counts (the recurrent families' scans take the training scans:
    no L4 or L5 launch)."""
    import torch
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.models import model as LM
    from repro_torch.models import steps as ST
    from repro_torch.optim import adamw
    full_layers = get_config(arch).n_layers
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                       total_steps=TRAIN_STEPS, remat=True,
                       microbatches=TRAIN_MICRO)
    t0 = time.time()
    params = LM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev, train=True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    batches = synthetic_token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                                      device=dev)
    first = next(batches)
    active = (f", {cfg.active_param_count()} active per token"
              if cfg.is_moe else "")
    log(f"[{tag}] {_describe(cfg)} ({cfg.n_layers} of {full_layers} "
        f"layers); {n_params} f32 parameters{active} "
        f"({4 * n_params / 1e9:.2f} GB) made in {time.time() - t0:.1f}s; "
        f"{tcfg}")
    train_check(params, cfg, {k: v[:1] for k, v in first.items()}, tag)
    torch.cuda.empty_cache()

    opt = adamw.init(dict(params.named_parameters()))
    step_fn = ST.make_train_step(cfg, tcfg)
    flops = _train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    n_attn = sum(_attention_calls(cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_s, finite = [], True
    for i in range(TRAIN_STEPS):
        batch = first if i == 0 else next(batches)
        before = read_counts()
        t1 = time.time()
        if i == TRAIN_STEPS - 1:
            params, opt, m = profile_train_step(step_fn, params, opt, batch,
                                                tag)
        else:
            params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        dt = time.time() - t1
        step_s.append(dt)
        after = read_counts()
        d1, d2, s1, s2, d4, d5 = (after[n] - before[n] for n in (
            "flash_attention", "flash_attention_bwd", "flash_attention_sm90",
            "flash_attention_bwd_sm90", "ssd_chunk", "wkv6"))
        loss, gn, lr = (float(m[k]) for k in ("loss", "grad_norm", "lr"))
        finite &= all(math.isfinite(x) for x in (loss, gn))
        aux = "".join(f", {k} {float(m[k]):.6f}" for k in ("moe_aux",
                                                            "moe_dropped")
                      if k in m)
        log(f"[{tag}] step {i + 1}: {dt:.3f}s, "
            f"{tokens_per_step / dt:.4g} tokens/s, loss {loss:.6f}, grad "
            f"norm {gn:.6f}, lr {lr:.4e}{aux}; L1 {d1} / L2 {d2} launches, "
            f"sm90 {s1} / {s2}, L4 {d4}, L5 {d5}"
            + (" (under the profiler)" if i == TRAIN_STEPS - 1 else ""))
        if (d1 != 2 * n_attn * TRAIN_MICRO or d2 != n_attn * TRAIN_MICRO):
            raise AssertionError(f"step {i + 1}: L1 {d1} and L2 {d2} "
                                 "launches, expected forward + recompute "
                                 "and one backward per attention call and "
                                 "microbatch")
        if (s1, s2) != (d1, d2):
            raise AssertionError(f"step {i + 1}: {d1 - s1} L1 and {d2 - s2} "
                                 "L2 launches of the bf16 step missed the "
                                 "sm90 kernels")
        if d4 or d5:
            raise AssertionError(f"step {i + 1}: L4 {d4} / L5 {d5} launches; "
                                 "a scan under autograd takes the training "
                                 "scan")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steady = step_s[1:-1]
    mean_s = sum(steady) / len(steady)
    log(f"[{tag}] {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens ({TRAIN_MICRO} microbatches, remat): steps 2-"
        f"{TRAIN_STEPS - 1} {mean_s:.3f} s/step, "
        f"{tokens_per_step / mean_s:.4g} tokens/s; model FLOPs "
        f"{flops / 1e12:.2f} TFLOP/step (6 per active matmul parameter and "
        f"token or frame, 12 hd per attended pair and head, 12 P N per scan "
        f"step and head, no recompute) = "
        f"{100 * flops / mean_s / _roof().PEAK_FLOPS['bf16']:.2f}% of the "
        f"989 TFLOP/s bf16 "
        f"peak; peak device memory {peak / 1e9:.2f} GB; launches {counts}")
    assert finite, "non-finite loss or grad norm on the train path"
    assert peak < 80e9, f"{arch}: peak device memory {peak / 1e9:.2f} GB"
    del params, opt
    torch.cuda.empty_cache()
    return counts


def profile_train_step(step_fn, params, opt, batch, tag="llm-train"):
    """One train step under ``torch.profiler``: device time by kernel and
    the device's busy share of the wall."""
    import torch
    torch.cuda.synchronize()
    with device_profile() as prof:
        t0 = time.time()
        out = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels, busy = device_time(prof)
    if not kernels:
        log(f"[{tag}-profile] the profiler recorded no device time: "
            "device busy share not measured")
        return out
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    log(f"[{tag}-profile] one step under the profiler: wall "
        f"{1e3 * wall:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (1e3 * wall):.1f}% of the wall), "
        f"{sum(c for _, c in kernels.values())} kernels; top: "
        + "; ".join(f"{k[:60]} {us / 1e3:.1f} ms x{c}"
                    for k, (us, c) in top))
    return out


def _group0_bytes(calls):
    """Collective bytes per slot by kind (the calls slot 0 takes part in,
    as the dry run records one slot's), without the zero kinds."""
    from repro_torch.roofline import analysis as ROOF
    out = ROOF.collective_bytes([c for c in calls if c.group == 0])
    return {k: v for k, v in out.items() if v}


# the 16 x 16 records of [sharded-llm-dryrun] as (arch, shape, int8
# cache): mixtral's prefill takes the moe FSDP branch (8 experts on 16
# model slots), whisper's decode reads its cross cache; read after
# [sharded-llm]
LOWERED = ((LLM_ARCH, "train_4k", False), (LLM_ARCH, "decode_32k", False),
           (MIXTRAL_ARCH, "prefill_32k", False),
           (WHISPER_ARCH, "decode_32k", False))
# and, planned after the debug mesh's plans and read after [sharded-int8]:
# zamba2's decode gathers its B / C histories, rwkv6's prefill runs L5 on 4
# of its 64 heads a slot, Qwen3-4B's decode_32k reads the int8 cache
LOWERED_LATE = ((HYBRID_ARCH, "decode_32k", False),
                (SSM_ARCH, "prefill_32k", False),
                (LLM_ARCH, "decode_32k", True))


def _planner_init(src):
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)


def _lower_one(arch, shape_name, kv_quant):
    """A planner job: ``launch.dryrun.lower_one`` on the 16 x 16 mesh
    (with ``kv_quant``, as ``--kv-quant`` runs it)."""
    from repro_torch.launch import dryrun as DRY
    return DRY.lower_one(arch, shape_name, False, verbose=False,
                         extra_tags={"kv_quant": True} if kv_quant else None)


def _debug_plan(arch, n_layers, kind, seq, batch):
    """A planner job: ``launch.dryrun.plan`` of one run on the debug mesh
    (``arch`` at ``n_layers``, ``batch`` x ``seq``): its launches per
    slot, planned peak bytes and seconds."""
    from repro_torch.configs.base import InputShape, TrainConfig, get_config
    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch.mesh import Mesh
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    p = DRY.plan(cfg, InputShape(kind, seq, batch, kind),
                 Mesh(SHARDED_MESH, ("data", "model")), kind,
                 TrainConfig(microbatches=TRAIN_MICRO, remat=True))
    return {"kernel_launches": p["kernel_launches"],
            "peak_bytes": p["memory"]["peak_bytes"], "plan_s": p["plan_s"]}


def start_plans():
    """The sharded phases' plans on ``meta`` (LOWERED, and the debug mesh's
    plans of [sharded-llm]'s and each family's runs) in one spawned
    process, so that their CPU time (~60 s on the H100's host) overlaps
    the card's phases: (the pool, which the caller shuts down, and {key:
    future}); a debug plan's key is (arch, kind)."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"),
        initializer=_planner_init, initargs=(str(SRC),))
    jobs = {("lower", a, sh, q): pool.submit(_lower_one, a, sh, q)
            for a, sh, q in LOWERED}
    from repro_torch.configs.base import get_config
    runs = [(LLM_ARCH, TRAIN_LAYERS)] + [(a, n)
                                        for _, a, n in SHARDED_FAMILY_RUNS]
    for arch, train_layers in runs:
        full = get_config(arch).n_layers
        for kind, n_layers, seq, batch in (
                ("prefill", full, LLM_CONTEXT, LLM_BATCH),
                ("decode", full, LLM_CONTEXT, LLM_BATCH),
                ("train", train_layers or full, TRAIN_SEQ, TRAIN_BATCH)):
            jobs[(arch, kind)] = pool.submit(_debug_plan, arch, n_layers,
                                             kind, seq, batch)
    jobs.update({("lower", a, sh, q): pool.submit(_lower_one, a, sh, q)
                 for a, sh, q in LOWERED_LATE})
    return pool, jobs


def check_plans(tag, jobs, arch, counted):
    """The debug mesh's plans of ``arch``'s runs against ``counted``
    ({kind: launches of the run}): planned launches per slot x the slots
    must be the counted ones."""
    n = SHARDED_MESH[0] * SHARDED_MESH[1]
    names_of = {"repro_torch::flash_attention": "flash_attention",
                "repro_torch::flash_attention_bwd": "flash_attention_bwd",
                "repro_torch::decode_attention": "decode_attention",
                "repro_torch::ssd_chunk": "ssd_chunk",
                "repro_torch::wkv6": "wkv6"}
    for what, counts in counted.items():
        p = jobs[(arch, what)].result()
        planned = {names_of[k]: v * n for k, v in
                   p["kernel_launches"].items()}
        want = {k: v for k, v in counts.items()
                if k in names_of.values() and v}
        log(f"[{tag}-dryrun] debug mesh {SHARDED_MESH} {what}: planned "
            f"launches per slot {p['kernel_launches']} (x {n} slots "
            f"{planned}), counted {want}; planned peak per slot "
            f"{p['peak_bytes'] / 1e9:.2f} GB, plan {p['plan_s']:.1f}s")
        assert planned == want, f"[{tag}] {what}: planned {planned}"


def phase_sharded_llm(dev, plans):
    """``[sharded-llm]``: Qwen3-4B at full width on ``make_debug_mesh(2,
    2)``, every slot a stream on the card (``_sharded_run``): serve at
    full depth with SHARDED_LLM_DECODE_STEPS decode steps (L1 144 per prefill
    and L3 144 per step: 36 layers x 4 slots), train at TRAIN_LAYERS for
    SHARDED_LLM_TRAIN_STEPS steps (L1 128 and L2 64 per step: 4 slots x the
    unsharded 32 / 16). Then the dry run (``plans``, from
    ``start_plans``): ``lower_one`` for train_4k and decode_32k on the 16
    x 16 mesh, mixtral-8x7b's prefill_32k (the moe FSDP branch: its
    expert weights all-gathered over 'data' in every layer) and
    whisper-medium's decode_32k (the cross cache). Returns the launch
    counts by path."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    tag = "sharded-llm"
    t_phase = time.time()
    out = _sharded_run(dev, LLM_ARCH, tag, make_debug_mesh(*SHARDED_MESH),
                       plans, SHARDED_LLM_DECODE_STEPS, TRAIN_LAYERS,
                       SHARDED_LLM_TRAIN_STEPS, grads_on_host=True)
    # -- the dry run, planned beside the card's work (``start_plans``)
    for arch, shape_name, quant in LOWERED:
        rec = _check_lowered(plans, arch, shape_name, quant)
        if arch == MIXTRAL_ARCH:
            # w_gate, w_up and w_down all-gathered over 'data' per layer
            assert rec["collectives"]["n_all-gather"] >= \
                3 * get_config(arch).n_layers, rec["collectives"]
    stamp(f"[{tag}] dry run ({time.time() - t_phase:.1f}s for the phase)")
    return {"sharded_serve": out["serve"], "sharded_train": out["train"]}


def _check_lowered(plans, arch, shape_name, quant):
    """The 16 x 16 record of ``arch`` at ``shape_name`` (``quant``: the
    int8 cache) from the planner (``start_plans``), printed; it must read
    ``ok``. Returns it."""
    rec = plans[("lower", arch, shape_name, quant)].result()
    rf = rec["roofline"]
    log(f"[sharded-llm-dryrun] {arch} {shape_name}"
        + (" (int8 cache)" if quant else "")
        + f" on 16 x 16 slots (one slot planned on meta in "
        f"{rec['plan_s']}s): launches per slot {rec['kernel_launches']}; "
        f"roofline per slot compute {rf['compute_s']:.4g}s, memory "
        f"{rf['memory_s']:.4g}s, collective {rf['collective_s']:.4g}s "
        f"({rf['dominant']}); planned peak "
        f"{rec['memory']['peak_bytes'] / 1e9:.2f} GB (fits 80 GB: "
        f"{rec['memory']['fits_80gb']}); collectives "
        f"{ {k: v for k, v in rec['collectives'].items() if v} }; useful "
        f"flops ratio {rec['useful_flops_ratio']:.4g}")
    assert rec["status"] == "ok", rec
    return rec


def _sharded_run(dev, arch, tag, mesh, plans, decode_steps, train_layers,
                 train_steps, grads_on_host=False):
    """``arch``'s sharded serve (``_sharded_serve``) and train
    (``_sharded_train``) on ``mesh``, then the debug mesh's plans of the
    two runs (``plans``, from ``start_plans``), whose launches per slot
    must be the counted ones over the slots. Returns {"serve": launches
    of the prefill and every decode step, "train": launches of a
    step}."""
    t_phase = time.time()
    pre_n, dec_n = _sharded_serve(dev, arch, tag, mesh, decode_steps)
    stamp(f"[{tag}] serve")
    train_n = _sharded_train(dev, arch, tag, mesh, train_layers,
                             train_steps, grads_on_host)
    stamp(f"[{tag}] train")
    check_plans(tag, plans, arch, {
        "prefill": pre_n,
        "decode": {k: v // decode_steps for k, v in dec_n.items()},
        "train": train_n})
    stamp(f"[{tag}] ({time.time() - t_phase:.1f}s for serve and train)")
    return {"serve": {k: pre_n[k] + dec_n[k] for k in pre_n},
            "train": train_n}


def _sharded_serve(dev, arch, tag, mesh, N):
    """``[sharded-*-serve]``: ``arch`` at full width and depth, the serve
    phase's prompt batch (a vlm prompt: its image positions, then text;
    an audio prompt: its text over 8 x 1,500 stub frames) and ``N``
    decode steps through the sharded prefill and serve steps, held
    against the unsharded serve on the card: LOGIT_TOL on the worst
    (sequence, step) pair, LOGIT_MEDIAN_TOL on the median decode step.
    The moe family, as ``phase_serve`` holds its serve path, takes
    LOGIT_TOL over the pairs at which an untimed replay kept the
    unsharded run's experts at every layer, at least SHARDED_MOE_MIN_KEPT
    of them, and the median over every step of the timed run, routing
    flips included. L1, L3, L4 and L5 launches are the slots x the
    unsharded counts. Returns (prefill launch counts, decode launch
    counts)."""
    import torch
    from unittest import mock
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.core.topology import record_collectives
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.models import model as LM
    from repro_torch.models import moe as MOE
    from repro_torch.models import steps as ST
    from repro_torch.sharding import partitioning as PART
    n = mesh.size
    cfg = get_config(arch)
    V = cfg.vocab_size
    n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
    prompt = LLM_PROMPT - n_img
    batch = next(synthetic_token_batches(cfg, LLM_BATCH, prompt + N + 3,
                                         seed=0, device=dev))
    tokens = batch.pop("tokens")
    shape = InputShape("serve_4k", LLM_CONTEXT, LLM_BATCH, "prefill")
    params = LM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    log(f"[{tag}] {_describe(cfg)} on {mesh}; prompt {LLM_BATCH} x "
        f"{LLM_PROMPT} positions"
        + "".join(f", {k} {tuple(v.shape)}" for k, v in batch.items()))
    # the unsharded serve on the card: the reference for the sharded one
    u_calls, s_calls = [], []
    prefill, serve = ST.make_prefill_step(cfg, shape), ST.make_serve_step(cfg)
    with mock.patch.object(MOE, "dispatch",
                           _dispatch_keeps(MOE.dispatch, u_calls)):
        logits, cache = prefill(params, {"tokens": tokens[:, :prompt],
                                         **batch})
        want = [logits]
        for t in range(prompt, prompt + N):
            logits, cache = serve(params, cache, tokens[:, t:t + 1])
            want.append(logits)
    del cache
    stamp(f"[{tag}] the unsharded serve")
    placed = PART.place(params, PART.param_specs(params, cfg, mesh), mesh)
    del params
    torch.cuda.empty_cache()
    sprefill = ST.make_sharded_prefill_step(cfg, shape, mesh)
    sserve = ST.make_sharded_serve_step(cfg, mesh)

    def run():
        """The sharded prefill and N decode steps: (logits, cache,
        prefill s, decode s, prefill launches, decode launches, the
        prefill's and first decode step's collectives)."""
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        with record_collectives() as pre_calls:
            lg, c = sprefill(placed, {"tokens": tokens[:, :prompt], **batch})
        out = [lg]
        torch.cuda.synchronize()
        pre_s, pre_n = time.time() - t0, read_counts()
        reset_counts()
        t0 = time.time()
        for t in range(prompt, prompt + N):
            with record_collectives() as calls:
                lg, c = sserve(placed, c, tokens[:, t:t + 1])
            if t == prompt:
                step_calls = calls
            out.append(lg)
        torch.cuda.synchronize()
        return (out, c, pre_s, time.time() - t0, pre_n, read_counts(),
                pre_calls, step_calls)

    torch.cuda.reset_peak_memory_stats()
    got, cache, pre_s, dec_s, pre_n, dec_n, pre_calls, step_calls = run()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    with device_profile() as prof:
        t0 = time.time()
        for t in range(prompt + N, prompt + N + 3):
            sserve(placed, cache, tokens[:, t:t + 1])
        torch.cuda.synchronize()
        wall = time.time() - t0
    # the dense model's window is read both ways once (``device_time``)
    _, busy = device_time(prof, check=arch == LLM_ARCH)
    busy_txt = (f"{100 * busy / (1e3 * wall):.1f}% of the wall"
                if busy else "not measured (no device time recorded)")
    del cache
    stamp(f"[{tag}] the sharded serve")
    got_t, want_t = torch.stack(got, 1)[:, :, 0], torch.stack(want, 1)[:, :, 0]
    ratio, per_step, agree, rms = _logit_gap(got_t, want_t, V)
    median = float(per_step[1:].median())
    log(f"[{tag}-serve] prefill {LLM_BATCH} x {LLM_PROMPT}: {pre_s:.3f}s, "
        f"{LLM_BATCH * LLM_PROMPT / pre_s:.4g} tokens/s; decode {N} steps: "
        f"{1e3 * dec_s / N:.3f} ms/step, {LLM_BATCH * N / dec_s:.4g} "
        f"tokens/s; 3 profiled steps {1e3 * wall / 3:.3f} ms/step, device "
        f"busy {busy_txt}; peak device memory {peak / 1e9:.2f} GB; "
        f"launches prefill {pre_n}, decode {dec_n}; collective bytes per "
        f"slot: prefill {_group0_bytes(pre_calls)}, one decode step "
        f"{_group0_bytes(step_calls)}")
    if cfg.is_moe:
        # an untimed replay that records each slot's kept experts: a
        # (sequence, step) whose experts differ from the unsharded run's
        # at any layer moves by that routing flip alone
        with mock.patch.object(MOE, "dispatch",
                               _dispatch_keeps(MOE.dispatch, s_calls)):
            r_logits = run()[0]
        pick = [i for i, s in enumerate(mesh.slots)
                if mesh.coord(s, "model") == 0]
        u_keep = _keeps_of(u_calls, cfg.n_layers, 1 + N)
        s_keep = _keeps_of(s_calls, cfg.n_layers, 1 + N, n, pick)
        flip = (u_keep != s_keep).any(dim=3).any(dim=0)     # (B, 1 + N)
        r_t = torch.stack(r_logits, 1)[:, :, 0]
        gap = (r_t[..., :V] - want_t[..., :V]).abs().amax(dim=2) / rms
        kept = int((~flip).sum())
        ratio = float(gap[~flip].max()) if kept else float("inf")
        log(f"[{tag}-serve] routing flips against the unsharded serve at "
            f"{int(flip.sum())} of {flip.numel()} (sequence, step) pairs, "
            f"{kept} kept (at least {SHARDED_MOE_MIN_KEPT}); the untimed "
            f"replay vs the unsharded serve over the kept pairs: max |d "
            f"logit| / rms {ratio:.4g}, over the flipped pairs "
            f"{float(gap[flip].max()) if flip.any() else 0.0:.4g}; replay "
            f"vs the timed run "
            f"{float((r_t - got_t)[..., :V].abs().max()) / rms:.4g}")
        assert kept >= SHARDED_MOE_MIN_KEPT, f"[{tag}] too few kept pairs"
    log(f"[{tag}-serve] vs the unsharded serve on the card: max |d logit| "
        f"/ rms(logits) {ratio:.4g} (limit {LOGIT_TOL[arch]}; rms "
        f"{rms:.4g}"
        + ("; the replay's kept pairs" if cfg.is_moe else "")
        + f"), prefill step {float(per_step[0]):.4g}, decode steps median "
        f"{median:.4g} (limit {LOGIT_MEDIAN_TOL[arch]}"
        + ("; the timed run, flips included" if cfg.is_moe else "")
        + f"); argmax agreement {agree:.4f}")
    # the slots x the unsharded serve's launches: L1 (sm90) per attention
    # layer and L4 / L5 per recurrent layer in the prefill, L3 per
    # attention layer in each decode step
    want = _expected_launches(cfg, N)
    _check_launches(f"{tag}-prefill", pre_n, {
        k: v * n for k, v in want.items() if k != "decode_attention"})
    _check_launches(f"{tag}-decode", dec_n, {
        "decode_attention": want["decode_attention"] * n})
    assert ratio <= LOGIT_TOL[arch], f"[{tag}] sharded serve vs unsharded"
    assert median <= LOGIT_MEDIAN_TOL[arch], \
        f"[{tag}] sharded decode steps vs unsharded"
    assert peak < 80e9
    del placed, got, want
    torch.cuda.empty_cache()
    return pre_n, dec_n


def _sharded_train(dev, arch, tag, mesh, n_layers, n_steps,
                   grads_on_host=False):
    """``[sharded-*-train]``: ``arch`` at full width and ``n_layers``
    (None: full depth) with the train phase's traffic (4 x 4,096 tokens
    in 2 microbatches, remat): the first batch's sharded gradients
    against the unsharded ones (TRAIN_* limits), then ``n_steps`` steps
    of each, loss and grad norm per step within TRAIN_LOSS_TOL /
    TRAIN_NORM_TOL (after the first: the moe family's grad norm within
    MOE_STEP_NORM_TOL, zamba2's loss within HYBRID_STEP_LOSS_TOL and
    rwkv6's grad norm within SSM_STEP_NORM_TOL), with L1 and L2 at the
    slots x the
    unsharded counts; step 1's gradients are the first batch's, gathered
    inside the step before its update (``grads_out``);
    step 1 records its collectives, the last runs under the profiler.
    ``grads_on_host``: the unsharded gradients wait on the host while the
    sharded step runs (Qwen3-4B's at 8 layers left the allocator 0.4 GB
    short of a logits shard beside the sharded state on the H100).
    Returns the launches of a step."""
    import torch
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.core.topology import record_collectives
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.models import model as LM
    from repro_torch.models import steps as ST
    from repro_torch.optim import adamw
    from repro_torch.sharding import partitioning as PART
    n = mesh.size
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers or full.n_layers)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                       total_steps=TRAIN_STEPS, remat=True,
                       microbatches=TRAIN_MICRO)
    gen = synthetic_token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                                  device=dev)
    batches = [next(gen) for _ in range(n_steps)]
    n_attn = sum(_attention_calls(cfg))

    def fresh():
        return LM.init_params(cfg, torch.Generator(
            device=dev).manual_seed(0), dev, train=True)

    params = fresh()
    names = [n_ for n_, _ in params.named_parameters()]
    opt = adamw.init(dict(params.named_parameters()))
    step = ST.make_train_step(cfg, tcfg)
    u_metrics, u_s, u_grads = [], [], {}
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.time()
        # step 1 keeps a copy of its gradients (the first batch's)
        params, opt, m = step(params, opt, b,
                              grads_out=u_grads if i == 0 else None)
        u_metrics.append({k: float(v) for k, v in m.items()})
        u_s.append(time.time() - t0)
    del params, opt, step
    if grads_on_host:
        u_grads = {n_: g.cpu() for n_, g in u_grads.items()}
    stamp(f"[{tag}] the unsharded train")
    params = fresh()
    pspecs = PART.param_specs(params, cfg, mesh)
    opt = adamw.init(dict(params.named_parameters()))
    ospecs = PART.opt_specs(opt, params, cfg, mesh)
    placed = PART.place(params, pspecs, mesh)
    popt = PART.place(opt, ospecs, mesh)
    del params, opt
    torch.cuda.empty_cache()
    stamp(f"[{tag}] placed")
    sstep = ST.make_sharded_train_step(cfg, tcfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s_s, busy_txt, counts, gaps = [], "not measured", None, []
    for i, b in enumerate(batches):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        last = i == len(batches) - 1
        if last:
            with device_profile() as prof:
                placed, popt, m = sstep(placed, popt, b)
                torch.cuda.synchronize()
        elif i == 0:
            # step 1 also gathers its whole gradients (the first batch's)
            # before the update, to hold them against the unsharded ones
            s_grads = {}
            with record_collectives() as train_calls:
                placed, popt, m = sstep(placed, popt, b, grads_out=s_grads)
        else:
            placed, popt, m = sstep(placed, popt, b)
        torch.cuda.synchronize()
        s_s.append(time.time() - t0)
        if i == 0:
            cos, norm_gap = _grad_stats([s_grads[n_] for n_ in names],
                                        (u_grads[n_].to(dev) for n_ in names))
            del s_grads, u_grads
            torch.cuda.empty_cache()
            d_loss0 = float(m["loss"]) - u_metrics[0]["loss"]
            depth = (f"{cfg.n_layers} of {full.n_layers} layers"
                     if cfg.n_layers != full.n_layers
                     else f"{cfg.n_layers} layers")
            log(f"[{tag}-train] {depth}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
                f"in {TRAIN_MICRO} microbatches a step; first batch's "
                f"gradients vs the unsharded step's: d loss {d_loss0:.3e}, "
                f"grad cosine {cos:.6f}, |g| ratio - 1 {norm_gap:.3e} "
                f"(limits {TRAIN_LOSS_TOL}, 1 - cosine {TRAIN_COS_TOL}, "
                f"{TRAIN_NORM_TOL})")
        if last:
            _, busy = device_time(prof)
            if busy:
                busy_txt = f"{100 * busy / (1e3 * s_s[-1]):.1f}% of the wall"
        counts = read_counts()
        _check_launches(f"{tag}-train step {i + 1}", counts, {
            "flash_attention": 2 * n_attn * TRAIN_MICRO * n,
            "flash_attention_sm90": 2 * n_attn * TRAIN_MICRO * n,
            "flash_attention_bwd": n_attn * TRAIN_MICRO * n,
            "flash_attention_bwd_sm90": n_attn * TRAIN_MICRO * n})
        w = u_metrics[i]
        got = {k: float(v) for k, v in m.items()}
        gaps.append((got["loss"] - w["loss"],
                     got["grad_norm"] / w["grad_norm"] - 1))
        aux = "".join(f", {k} {got[k]:.6f} (unsharded {w[k]:.6f})"
                      for k in ("moe_aux", "moe_dropped") if k in got)
        log(f"[{tag}-train] step {i + 1}: sharded {s_s[-1]:.3f}s, loss "
            f"{got['loss']:.6f}, grad norm {got['grad_norm']:.6f}{aux}; "
            f"unsharded {u_s[i]:.3f}s, loss {w['loss']:.6f}, grad norm "
            f"{w['grad_norm']:.6f}; |g| ratio - 1 {gaps[-1][1]:.3e}"
            + (" (sharded under the profiler)" if last else ""))
    peak = torch.cuda.max_memory_allocated()
    tok = TRAIN_BATCH * TRAIN_SEQ
    log(f"[{tag}-train] {len(batches)} steps: sharded "
        f"{' / '.join(f'{x:.3f}' for x in s_s)} s (the last profiled), "
        f"{tok / s_s[0]:.4g} tokens/s at step 1, busy {busy_txt}, peak "
        f"device memory {peak / 1e9:.2f} GB; unsharded "
        f"{' / '.join(f'{x:.3f}' for x in u_s)} s; collective bytes per "
        f"slot in step 1 {_group0_bytes(train_calls)}; launches a step "
        f"{counts}")
    assert abs(d_loss0) <= TRAIN_LOSS_TOL, f"[{tag}] sharded train loss"
    assert 1.0 - cos <= TRAIN_COS_TOL, f"[{tag}] sharded gradients"
    assert abs(norm_gap) <= TRAIN_NORM_TOL, f"[{tag}] sharded gradient norm"
    for i, (dl, dn) in enumerate(gaps):
        loss_tol, norm_tol = TRAIN_LOSS_TOL, TRAIN_NORM_TOL
        if i and cfg.is_moe:
            norm_tol = MOE_STEP_NORM_TOL
        elif i and cfg.family == "hybrid":
            loss_tol = HYBRID_STEP_LOSS_TOL
        elif i and cfg.family == "ssm":
            norm_tol = SSM_STEP_NORM_TOL
        assert abs(dl) <= loss_tol, f"[{tag}] step {i + 1}: loss"
        assert abs(dn) <= norm_tol, f"[{tag}] step {i + 1}: grad norm"
    assert peak < 80e9
    del placed, popt
    torch.cuda.empty_cache()
    return counts


def phase_sharded_families(dev, plans):
    """``[sharded-vlm]``, ``[sharded-moe]``, ``[sharded-audio]``,
    ``[sharded-hybrid]``, ``[sharded-ssm]``: internvl2-1b,
    granite-moe-1b-a400m, whisper-medium, zamba2-7b and rwkv6-7b as SPMD
    programs on ``make_debug_mesh(2, 2)`` (4 slots, each a stream on the
    card), each through ``_sharded_run``: serve at full width and depth
    with SHARDED_DECODE_STEPS decode steps (L1 / L3 per attention layer,
    L4 / L5 per recurrent layer, 4 x the unsharded counts), train at full
    width and SHARDED_FAMILY_RUNS' depth for SHARDED_TRAIN_STEPS steps.
    Returns the launch counts by path."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(*SHARDED_MESH)
    t_all = time.time()
    out = {}
    for tag, arch, layers in SHARDED_FAMILY_RUNS:
        log(f"[{tag}] train depth cut to {layers} of "
            f"{get_config(arch).n_layers} layers at full width (the serve "
            f"runs every layer)")
        out[tag] = _sharded_run(dev, arch, tag, mesh, plans,
                                SHARDED_DECODE_STEPS, layers,
                                SHARDED_TRAIN_STEPS)
        stamp(f"[{tag}]")
    log(f"[sharded-families] the five phases {time.time() - t_all:.1f}s")
    return out


def phase_train_spread(dev):
    """``[train-spread]`` (``--train-spread`` only): the control for the
    recurrent families' sharded train limits after the first step. For
    zamba2-7b and rwkv6-7b at SHARDED_FAMILY_RUNS' depths, the unsharded
    step twice from the same seeded f32 master weights and the sharded
    train phase's first 2 batches: in the published bf16 compute and in
    f32; prints each step's loss and grad norm and the bf16 step's
    distance from the f32 one (d loss, |g| ratio - 1)."""
    import torch
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.models import model as LM
    from repro_torch.models import steps as ST
    from repro_torch.optim import adamw
    for _, arch, layers in SHARDED_FAMILY_RUNS:
        if get_config(arch).family not in ("hybrid", "ssm"):
            continue
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                           total_steps=TRAIN_STEPS, remat=True,
                           microbatches=TRAIN_MICRO)
        gen = synthetic_token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                                      device=dev)
        batches = [next(gen) for _ in range(SHARDED_TRAIN_STEPS)]
        out = {}
        for name, c in (("bf16", cfg),
                        ("f32", dataclasses.replace(cfg, dtype="float32"))):
            params = LM.init_params(c, torch.Generator(
                device=dev).manual_seed(0), dev, train=True)
            opt = adamw.init(dict(params.named_parameters()))
            step = ST.make_train_step(c, tcfg)
            out[name] = []
            for b in batches:
                params, opt, m = step(params, opt, b)
                out[name].append({k: float(v) for k, v in m.items()})
            del params, opt, step
            torch.cuda.empty_cache()
        for i, (a, b) in enumerate(zip(out["bf16"], out["f32"])):
            log(f"[train-spread] {arch} at {layers} layers step {i + 1}: "
                f"bf16 loss {a['loss']:.6f} grad norm {a['grad_norm']:.6f}; "
                f"f32 loss {b['loss']:.6f} grad norm {b['grad_norm']:.6f}; "
                f"d loss {a['loss'] - b['loss']:.3e}, |g| ratio - 1 "
                f"{a['grad_norm'] / b['grad_norm'] - 1:.3e}")
        stamp(f"[train-spread] {arch}")


def _shard_bytes(tree, specs, mesh):
    """Bytes of one slot's shards of a (meta) tree under ``specs``."""
    from repro_torch.sharding import partitioning as PART
    if isinstance(tree, dict):
        return sum(_shard_bytes(v, specs[k], mesh) for k, v in tree.items())
    if not hasattr(tree, "shape"):
        return 0
    return math.prod(PART.shard_shape(mesh, specs, tuple(tree.shape))) \
        * tree.element_size()


def phase_sharded_int8(dev, plans):
    """``[sharded-int8]``: Qwen3-4B at full width and depth, the int8
    cache's sharded decode on ``make_debug_mesh(2, 2)``: SHARDED_INT8_SLOTS
    slots for LLM_BATCH sequences, filled from empty by
    SHARDED_INT8_PROMPT tokens through the decode step, then
    SHARDED_INT8_STEPS more, against the unsharded int8 decode of the same
    tokens on the card: LOGIT_TOL on the worst (sequence, step), the
    median step within LOGIT_MEDIAN_TOL. Each slot's cache bytes equal
    its spec's on ``meta``; neither run launches a kernel (the int8 cache
    is read by the plain ``layers.flash_attend``, as unsharded). Then the
    late [sharded-llm-dryrun] records (``LOWERED_LATE``). Returns the
    sharded run's launch counts."""
    import torch
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.core.topology import record_collectives
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import kvcache as KV
    from repro_torch.models import model as LM
    from repro_torch.models import sharded as SH
    from repro_torch.models import steps as ST
    from repro_torch.sharding import partitioning as PART
    tag = "sharded-int8"
    t_phase = time.time()
    cfg = get_config(LLM_ARCH)
    mesh = make_debug_mesh(*SHARDED_MESH)
    n_tok = SHARDED_INT8_PROMPT + SHARDED_INT8_STEPS
    tokens = next(synthetic_token_batches(cfg, LLM_BATCH, n_tok, seed=3,
                                          device=dev))["tokens"]
    params = LM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    log(f"[{tag}] {_describe(cfg)} on {mesh}; {LLM_BATCH} sequences into "
        f"an int8 cache of {SHARDED_INT8_SLOTS} slots: {SHARDED_INT8_PROMPT}"
        f" prompt tokens by the decode step, then {SHARDED_INT8_STEPS} "
        f"steps")

    def decode(step, weights, cache):
        """n_tok decode steps: (logits (B, n_tok, Vp), prompt ms/step,
        decode ms/step, launches, the first step's collectives)."""
        kept = []
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        with record_collectives() as calls:
            kept.append(step(weights, cache, tokens[:, :1])[0][:, 0])
        first = list(calls)
        for t in range(1, n_tok):
            if t == SHARDED_INT8_PROMPT:
                torch.cuda.synchronize()
                t1 = time.time()
            kept.append(step(weights, cache, tokens[:, t:t + 1])[0][:, 0])
        torch.cuda.synchronize()
        t2 = time.time()
        return (torch.stack(kept, 1), 1e3 * (t1 - t0) / SHARDED_INT8_PROMPT,
                1e3 * (t2 - t1) / SHARDED_INT8_STEPS, read_counts(), first)

    # the unsharded int8 decode: the reference for the sharded one
    cache = KV.serve_cache_init(cfg, LLM_BATCH, SHARDED_INT8_SLOTS,
                                device=dev, kv_quant=True)
    want, u_prompt, u_step, u_n, _ = decode(ST.make_serve_step(cfg), params,
                                            cache)
    del cache
    placed = PART.place(params, PART.param_specs(params, cfg, mesh), mesh)
    del params
    torch.cuda.empty_cache()
    lm = SH.ShardedLM(cfg, mesh)
    cache = lm.cache_init(LLM_BATCH, SHARDED_INT8_SLOTS, kv_quant=True)
    spec = ST.cache_specs_quant(cfg, InputShape(
        "int8", SHARDED_INT8_SLOTS, LLM_BATCH, "decode"))
    spec_bytes = _shard_bytes(spec, PART.cache_specs(spec, cfg, None, mesh),
                              mesh)
    slot_bytes = {s: _tensor_bytes(c) for s, c in cache.items()}
    torch.cuda.reset_peak_memory_stats()
    got, s_prompt, s_step, s_n, calls = decode(
        ST.make_sharded_serve_step(cfg, mesh), placed, cache)
    peak = torch.cuda.max_memory_allocated()
    assert all(c["pos"] == n_tok for c in cache.values())
    assert cache[mesh.slots[0]]["attn"]["k"].dtype == torch.int8
    del cache, placed
    torch.cuda.empty_cache()
    gap, per_step, agree, rms = _logit_gap(got, want, cfg.vocab_size)
    median = float(per_step.median())
    log(f"[{tag}] cache per slot {slot_bytes[mesh.slots[0]] / 1e6:.3f} MB "
        f"(its spec on meta: {spec_bytes / 1e6:.3f} MB; spec "
        f"{lm.cache_spec}); sharded: prompt {s_prompt:.2f} ms/step, decode "
        f"{s_step:.2f} ms/step, {LLM_BATCH * 1e3 / s_step:.4g} tokens/s, "
        f"peak device memory {peak / 1e9:.2f} GB, launches {s_n}, "
        f"collective bytes per slot in the first step "
        f"{_group0_bytes(calls)}; unsharded: prompt {u_prompt:.2f} ms/step, "
        f"decode {u_step:.2f} ms/step, launches {u_n}")
    log(f"[{tag}] vs the unsharded int8 decode over {n_tok} steps: max |d "
        f"logit| / rms {gap:.4g} (limit {LOGIT_TOL[LLM_ARCH]}; rms "
        f"{rms:.4g}), median step {median:.4g} (limit "
        f"{LOGIT_MEDIAN_TOL[LLM_ARCH]}); argmax agreement {agree:.4f}")
    _check_launches(tag, s_n, {})
    _check_launches(f"{tag}-unsharded", u_n, {})
    assert all(b == spec_bytes for b in slot_bytes.values()), \
        f"[{tag}] cache bytes per slot {slot_bytes}, spec {spec_bytes}"
    assert bool(torch.isfinite(got).all()), f"[{tag}] non-finite logits"
    assert gap <= LOGIT_TOL[LLM_ARCH], f"[{tag}] sharded vs unsharded int8"
    assert median <= LOGIT_MEDIAN_TOL[LLM_ARCH], \
        f"[{tag}] sharded int8 decode steps vs unsharded"
    assert peak < 80e9
    stamp(f"[{tag}] ({time.time() - t_phase:.1f}s)")
    # the late records' launches per slot: zamba2's decode L3 once per
    # shared-block application, rwkv6's prefill L5 once per layer, the int8
    # decode none (its K / V gathered over 'model' like bf16 ones: 8 KV
    # heads on 16 slots split hd)
    hybrid = get_config(HYBRID_ARCH)
    planned = {HYBRID_ARCH: {"repro_torch::decode_attention":
                             hybrid.n_layers // hybrid.shared_attn_period},
               SSM_ARCH: {"repro_torch::wkv6": get_config(SSM_ARCH).n_layers},
               LLM_ARCH: {}}
    for arch, shape_name, quant in LOWERED_LATE:
        rec = _check_lowered(plans, arch, shape_name, quant)
        assert rec["kernel_launches"] == planned[arch], rec["kernel_launches"]
        if quant:
            assert rec["collectives"]["n_all-gather"] >= 2 * cfg.n_layers
    stamp("[sharded-llm-dryrun] the late records")
    return s_n


def main(argv):
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py needs the repository's src/repro_torch beside "
              "it", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import resolve_device
    from repro_torch.configs.base import get_config
    from repro_torch.core import bmf as BMF
    dev = resolve_device("cuda")
    if "--train-spread" in argv:
        phase_build()
        stamp("build")
        phase_train_spread(dev)
        return 0

    # the kernels build (nvcc processes) while the host makes the
    # MovieLens-shape data
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        built = pool.submit(phase_build)
        preset, train, test, test_p, part = make_data()
        built.result()
    stamp("build and data")
    K = preset.K
    parity = phase_parity(part, test_p, K, dev)
    phase_quickstart(dev)
    cfg = BMF.BMFConfig(K=K, n_samples=SAMPLES, burnin=BURNIN)
    fused = cfg._replace(sweep_fused=True)
    phase_dryrun(part, test_p, fused, dev, "movielens")
    phase_dryrun_cli()
    stamp("parity, quickstart and dryrun")
    launches = {}
    counts, stacked_fused, stacked_peak = phase_main(
        train, test, part, fused, "fused-sweep", "bmf_sweep", dev)
    launches["bmf_sweep"] = counts["bmf_sweep"]
    b2_by_path = {"stacked": counts["bmf_sweep"],
                  **phase_overlapped(train, test, part, fused, stacked_fused,
                                     stacked_peak, dev)}
    placed = cut_rows(train, test, part, PLACEMENT_ROWS)
    counts, placed_ref, placed_peak = phase_main(
        *placed, fused, f"fused-sweep-rows/{PLACEMENT_ROWS}", "bmf_sweep",
        dev)
    b2_by_path[f"stacked-rows/{PLACEMENT_ROWS}"] = counts["bmf_sweep"]
    grouped, async_groups = phase_groups(*placed, fused, placed_ref,
                                         placed_peak, dev)
    b2_by_path.update(grouped)
    b1_sharded, b2_sharded = phase_sharded(*placed, fused, placed_ref,
                                           placed_peak, dev)
    b2_by_path.update(b2_sharded)
    phase_group_faults(*placed, fused, async_groups, dev)
    del async_groups, placed, placed_ref
    counts, _, _ = phase_main(train, test, part,
                              cfg._replace(use_kernel=True), "use-kernel",
                              "bmf_precision", dev)
    launches["bmf_precision"] = counts["bmf_precision"]
    phase_bmf_sync(part, test, fused, dev)
    stamp("BMF executors and placements")
    phase_bmf_serve(train, test, stacked_fused, dev)
    lint_launches = phase_lint(part, test, test_p, K, dev)
    stamp("BMF serving and lint")
    del train, test, test_p, part, stacked_fused
    torch.cuda.empty_cache()
    als_launches, table2_cases = phase_table2(dev)
    b1_cases, netflix_launches, netflix_streaming = phase_netflix(dev)
    stamp("table 2 and Netflix")
    llm_parity = phase_llm_parity(dev)
    llm_counts = phase_serve(dev, LLM_ARCH, "llm")
    stamp("LLM parity and Qwen3 serve")
    shape_counts = phase_serving_shapes(dev)
    stamp("serving shapes (prefill_32k, int8 decode_32k, long_500k)")
    launches.update({n: llm_counts[n] for n in llm_parity})
    launches["flash_attention_sm90"] = llm_counts["flash_attention_sm90"]
    llm_parity["flash_attention_bwd"] = phase_l2_parity(dev)
    train_counts = phase_llm_train(dev)
    stamp("L2 parity and Qwen3 train")
    launches["flash_attention_bwd"] = train_counts["flash_attention_bwd"]
    launches["flash_attention_bwd_sm90"] = train_counts[
        "flash_attention_bwd_sm90"]
    pool, plans = start_plans()
    try:
        sharded = phase_sharded_llm(dev, plans)
        families = phase_sharded_families(dev, plans)
        sharded_int8 = phase_sharded_int8(dev, plans)
    finally:
        pool.shutdown(cancel_futures=True)
    stamp("sharded families and int8")
    for name, cases in phase_hd112_parity(dev).items():
        llm_parity[name] += cases
    llm_parity.update(phase_scan_parity(dev))
    phase_scan_train_parity(dev)
    hybrid_counts = phase_serve(dev, HYBRID_ARCH, "zamba2")
    ssm_counts = phase_serve(dev, SSM_ARCH, "rwkv6")
    launches["ssd_chunk"] = hybrid_counts["ssd_chunk"]
    launches["wkv6"] = ssm_counts["wkv6"]
    stamp("recurrent serve")
    for name, cases in phase_hd64_parity(dev).items():
        llm_parity[name] += cases
    serve_counts = {"serve": llm_counts, "serve_zamba2": hybrid_counts,
                    "serve_granite": phase_serve(dev, MOE_ARCH, "granite"),
                    "serve_mixtral": phase_serve(dev, MIXTRAL_ARCH, "mixtral",
                                                 n_layers=MIXTRAL_LAYERS,
                                                 past=RING_WRAP_STEPS),
                    "serve_internvl2": phase_serve(dev, VLM_ARCH,
                                                   "internvl2"),
                    "serve_sharded": sharded["sharded_serve"],
                    **{"serve_" + t.replace("-", "_"): c["serve"]
                       for t, c in families.items()},
                    "serve_sharded_int8": sharded_int8,
                    **shape_counts}
    stamp("moe and vlm serve")
    train = {"train": train_counts,
             "train_sharded": sharded["sharded_train"],
             **{"train_" + t.replace("-", "_"): c["train"]
                for t, c in families.items()},
             "train_granite": phase_llm_train(
                 dev, MOE_ARCH, get_config(MOE_ARCH).n_layers, "moe-train")}
    stamp("moe train")
    for name, cases in phase_whisper_parity(dev).items():
        llm_parity[name] += cases
    serve_counts["serve_whisper"] = phase_serve(dev, WHISPER_ARCH, "whisper")
    train["train_whisper"] = phase_llm_train(
        dev, WHISPER_ARCH, get_config(WHISPER_ARCH).n_layers, "whisper-train")
    stamp("whisper parity, serve and train")
    train["train_zamba2"] = phase_llm_train(
        dev, HYBRID_ARCH, HYBRID_TRAIN_LAYERS, "hybrid-train")
    train["train_rwkv6"] = phase_llm_train(dev, SSM_ARCH, SSM_TRAIN_LAYERS,
                                           "ssm-train")
    stamp("hybrid and ssm train")
    phase_examples()
    stamp("examples")
    by_path = {name: {path: c[name] for path, c in
                      {**serve_counts, **train}.items()}
               for name in ("flash_attention", "flash_attention_sm90")}
    by_path.update({name: {path: c[name] for path, c in train.items()}
                    for name in ("flash_attention_bwd",
                                 "flash_attention_bwd_sm90")})
    by_path["decode_attention"] = {path: c["decode_attention"]
                                   for path, c in serve_counts.items()}
    # the recurrent scans: L4 / L5 per prefill layer on the serve paths
    # (the sharded ones on each slot), none on the train paths (the
    # training scans)
    for name, arch, tag in (("ssd_chunk", "zamba2", "hybrid"),
                            ("wkv6", "rwkv6", "ssm")):
        by_path[name] = {
            f"serve_{arch}": launches[name],
            f"train_{arch}": train[f"train_{arch}"][name],
            f"serve_sharded_{tag}": serve_counts[f"serve_sharded_{tag}"][name],
            f"train_sharded_{tag}": train[f"train_sharded_{tag}"][name]}

    meta = {
        "bmf_precision": dict(
            source="src/repro_torch/csrc/bmf_precision.cu",
            replaces="src/repro/kernels/bmf_precision/kernel.py:100",
            design="K <= 16: one thread per row, Lam's lower triangle and "
                   "eta in registers (B2's accumulate), a warp's rows "
                   "written through shared memory in 16-byte stores; "
                   "16 < K <= 128: persistent blocks, a producer warp "
                   "gathering factor rows by the TMA into a 3-stage ring "
                   "of 32-slot chunks, 4 consumer warps adding Lam's lower "
                   "16 x 16 tiles on mma.sync (fp32 3xTF32 split, bf16 "
                   "exact) and eta on the CUDA cores, Lam staged in "
                   "shared memory and stored as one contiguous span",
            cases=b1_cases + table2_cases,
            launches_by_path={"use-kernel": launches["bmf_precision"],
                              "netflix-k100": netflix_launches,
                              "netflix-k100-streaming": netflix_streaming,
                              "als": als_launches, **b1_sharded,
                              "lint": lint_launches["bmf_precision"]}),
        "bmf_sweep": dict(
            source="src/repro_torch/csrc/bmf_sweep.cu",
            replaces="src/repro/kernels/bmf_sweep/kernel.py:232",
            design="one thread per row up to K = 16: the slots' factor rows "
                   "added into Lam's lower triangle in registers, an "
                   "in-thread Cholesky and solves with no shuffle; one warp "
                   "per row above",
            launches_by_path={**b2_by_path,
                              "lint": lint_launches["bmf_sweep"]}),
    }
    kernels = []
    for name, m in meta.items():
        fp32, bf16 = parity[(name, "fp32")], parity[(name, "bf16")]
        kernels.append(dict(name=name, route="cuda", source=m["source"],
                            replaces=m["replaces"], launches=launches[name],
                            max_abs_err=fp32["max_abs_err"], ms=fp32["ms"],
                            plain_ms=fp32["plain_ms"],
                            bound_ms=fp32["bound_ms"],
                            bound_by=fp32["bound_by"], library_ms=None,
                            tb_per_s=fp32["tb_per_s"], design=m["design"],
                            bf16=bf16,
                            **{k: m[k] for k in ("cases", "launches_by_path")
                               if k in m}))
    # L1 and L2 run bf16 on the path (the sm90 kernels); their f32 kernels
    # stand beside them as a second variant
    llm_meta = {
        "flash_attention": dict(
            source="src/repro_torch/csrc/flash_attention_sm90.cu",
            f32_source="src/repro_torch/csrc/flash_attention.cu",
            f32_design="3xTF32 mma.sync m16n8k8 (x = hi + lo; lo.hi + hi.lo "
                       "+ hi.hi) in partials of at most 4 depth steps added "
                       "in f32: 8 warps x 16 query rows, q raw in shared "
                       "memory, 32-key K/V tiles by cp.async into a raw "
                       "stage and split once per tile into shared planes, "
                       "online softmax on the accumulators, P fed to P V "
                       "from its accumulators (permuted depth slots), one "
                       "block an SM",
            replaces="src/repro/kernels/flash_attention/kernel.py:90"),
        "flash_attention_bwd": dict(
            source="src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
            f32_source="src/repro_torch/csrc/flash_attention_bwd.cu",
            f32_design="3xTF32 mma.sync m16n8k8 in partials added in f32, "
                       "two passes of 8 warps, no atomics: dq pass (128 "
                       "query rows, q and do raw in shared memory, D formed) "
                       "over 16-key tiles; dk/dv pass (64 keys, K and V raw "
                       "in shared memory, the GQA sum inside) over the "
                       "group's 16-query tiles, a warp pair per 16 keys (dv "
                       "warp: s, p, p^T do; dk warp: dp, ds, ds^T q, p^T "
                       "through shared memory); streamed tiles by cp.async, "
                       "split once into row and pair planes",
            replaces="src/repro/kernels/flash_attention/kernel_bwd.py:108"),
        "decode_attention": dict(
            source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention/kernel.py:70",
            design="pipelined split-KV: 32-slot K/V tiles in their own dtype "
                   "in a 4-stage cp.async ring, lane groups per slot, f32 "
                   "online softmax, split count from split_plan (one split "
                   "writes the output, more add a combine launch); ms one "
                   "call, device_ms_per_call in a CUDA graph"),
        "ssd_chunk": dict(
            source="src/repro_torch/csrc/ssd_chunk.cu",
            replaces="src/repro/kernels/ssd_chunk/kernel.py:56",
            design="tensor-core SSD scan: mma.sync bf16 hi + lo split "
                   "operands (3 products), C B^T shared by 2 heads per "
                   "block, state in mma accumulators, cp.async double "
                   "buffer"),
        "wkv6": dict(
            source="src/repro_torch/csrc/wkv6.cu",
            replaces="src/repro/kernels/wkv6/kernel.py:65",
            design="tensor-core WKV scan: mma.sync bf16 hi + lo split "
                   "operands (3 products) read by ldmatrix from tiles split "
                   "once per chunk, state in mma accumulators, the next "
                   "chunk's r, k, v by cp.async and logw in registers"),
    }
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    for name, m in llm_meta.items():
        main_case = llm_parity[name][0]   # the path's shape (L1-L3 bf16)
        entry = dict(
            name=name, route="cuda", source=m["source"],
            replaces=m["replaces"], launches=launches[name],
            **{k: main_case[k] for k in timed},
            **{k: main_case[k] for k in ("device_ms_per_call",
                                         "library_device_ms_per_call")
               if k in main_case},
            case=main_case["case"], cases=llm_parity[name][1:],
            **({"design": m["design"]} if "design" in m else {}),
            **({"launches_by_path": by_path[name]} if name in by_path
               else {}))
        if "f32_source" in m:
            f32 = next(c for c in llm_parity[name] if c["dtype"] == "fp32"
                       and c["case"] == main_case["case"])
            sm90_by_path = by_path[f"{name}_sm90"]
            entry["variants"] = [
                dict(variant="sm90", dtype="bf16", source=m["source"],
                     launches=launches[f"{name}_sm90"],
                     launches_by_path=sm90_by_path,
                     **{k: main_case[k] for k in timed}),
                dict(variant="f32", dtype="fp32", source=m["f32_source"],
                     design=m["f32_design"],
                     launches=launches[name] - launches[f"{name}_sm90"],
                     launches_by_path={
                         path: n - sm90_by_path[path]
                         for path, n in by_path[name].items()},
                     cuda_core_bound_ms=f32["cuda_core_bound_ms"],
                     **{k: f32[k] for k in timed})]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
