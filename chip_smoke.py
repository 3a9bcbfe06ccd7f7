#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py          # from the root of a repository checkout

Phases, in order; any failure propagates and the exit code is non-zero:

1. set-up: build every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once), count the tensor-core (HGMMA),
   TMA (UTMALDG) and mbarrier (SYNCS) instructions in the SASS of the B1
   and B3 libraries and the tensor-core (HMMA), cp.async (LDGSTS) and
   ldmatrix (LDSM) instructions in B4's, print the card's name and power
   limit, turn TF32 off; [analysis] the port's contract lint
   (``repro_torch.analysis.lint --check``: 0 findings against the empty
   ``LINT_BASELINE_TORCH.json``) and its kernel report
   (``kernel_report --check --libs``): every instantiation in the built
   libraries read by ``cuobjdump --dump-resource-usage``, one line each
   (registers against the ceiling, spills from this run's ``ptxas`` log,
   local memory, static shared memory against the model's), and each
   kernel's shared memory per CTA at its budget's nominal dims, the
   library's static size plus the dynamic size its launch function gives
   (asked of the library), against the model's;
2. [kernel] each kernel against its plain PyTorch version on the card:
   flash attention (B3) at the serving path's shape and at GQA / window /
   f32 / ragged / lane-masked cases, at head dims 16 (the reduced configs,
   f32) and 112 (zamba2-7b, bf16) too, at [serve-moe]'s (1, 1024, 16,
   128) and [serve-hybrid]'s (1, 1024, 32, 112) prefill shapes (both
   timed), at [serve-vlm]'s longest prefill (1, 881, 28 query heads on 4
   KV heads, 128) causal and [serve-encdec]'s encoder (1, 1024, 16, 64)
   bidirectional (both timed), at [train-lm]'s pool-step shape
   (4, 512, 32, 64) bf16 causal, and ``torch.func.vmap(grad)`` of a loss
   through ``ops.flash_attention`` (one B3 launch per vmapped call) against
   the same through ``sdpa_chunked``, in f32 (simt body) and at
   [train-lm]'s 2 lanes of (2, 512, 32, 64) bf16 (wgmma body); the packed
   GEMM (B1) at the
   reference test shapes, strided and lane-masked, timed in both of the kernel-mode
   step's orientations (x, and the gradient GEMM's x^T view); the RMSNorm
   pair (B2 lane-batched, B5 rows), masked, and B2's lanes against B5 bit
   for bit, on rows held in registers and on longer rows read twice; the
   SSD scan (B4) at a reference test shape, ragged chunks, b = 4 and the
   serving prefills' shapes (mamba2-130m's 24 heads with N = 128, and
   zamba2-7b's 112 heads with N = 64, timed), in f32 and bf16, through the
   model's strided
   views and lane-masked, its three CUDA kernels timed apart; a Mamba2
   block's gradient on the card (through the chunked scan, no B4 launch)
   against the CPU's; each timed beside its bound and, where one
   exists, a PyTorch library call (CUDA events and profiler device time
   for both);
   B1 and B3 run their tensor-core (wgmma) bodies on bf16 and their
   CUDA-core (simt) bodies on f32;
3. [small] narrow f32 models served on the card (kernel path) and on the
   CPU (chunked path) from the same parameters must agree: a head-dim-64
   variant of the reduced StableLM-2, the stock reduced config (head
   dim 16), the reduced DeepSeekMoE and the reduced Zamba2 with a tail
   (B4's f32 body too); the reduced Qwen2-VL and SeamlessM4T (prefill
   and 3 decode steps each) and the reduced ResNet-18 (width 0.25, 16 px:
   logits, loss and two steps of a 2-lane ``packed_step``);
4. [serve] the serving path: ``BatchServer`` serving 8 requests on
   full-width StableLM-2 1.6B (random weights from a seed), with every
   kernel's launch count read around that run (B3's by body: all on the
   tensor-core body), the longest prompt's prefill logits through the
   kernels against their plain versions, each kernel call of that prefill
   against its plain version on its served inputs, then the same requests
   with ``adaptive_lanes``; [profile] device time by kernel and by kind and
   the device's idle share for one prefill and one 4-lane decode step
   (torch.profiler); [serve-ssm] the same for full-width mamba2-130m, whose
   prefills run B4 (24 launches each, its CUDA kernels counted in a traced
   repeat); [serve-moe] the same for DeepSeekMoE-16B at its published
   width, depth cut to 14 of 28 layers (B3 14 launches a prefill; each decode step routes
   every lane's token alone; the assignments each prefill's capacity
   dropped, and the top-k sets that differ between the kernel and plain
   routes, logged; the [profile] with its expert-weight casts' share) and
   [serve-hybrid] for Zamba2-7B at its published width and depth (B3 13
   launches and B4 81 a prefill; the bf16 route's rounding twins logged
   and the two routes held in f32 too); then [serve-vlm], Qwen2-VL-7B at
   its published width and depth (4 requests of a text prefix, one image
   of merged patches and a text suffix, fed as embeddings with distinct
   M-RoPE streams; 28 B3 launches a prefill) and [serve-encdec],
   SeamlessM4T-medium likewise (4 requests of 512-1024 encoder frames and
   a short decoder prompt; 24 B3 launches a prefill, the encoder's 12
   bidirectional): each request's ``Model.prefill`` at batch 1, then
   greedy ``decode_step``s (no B3 launch), the longest request's prefill
   through the kernels against the plain versions (each B3 call on its
   served inputs too, and both routes in f32), a [profile] of one prefill
   and one decode step;
5. [train-lenet] the paper's workflow: a triples plan, the profile of one
   LeNet-4 step at batch 64, 8 packed lanes with per-lane learning rates,
   a ``RefillExecutor`` over 24 tasks in "where" and "compact" mode, a
   drain to a ``PoolSnapshot`` resumed at capacity 4, and the packed step
   time against concurrency (the paper's Figs 4-5);
6. [train-kernel] the lane pool's "kernel" mode: ``LanePool(exec_mode=
   "kernel")`` running the reference's pool-level step, whose two GEMMs
   go through B1 (its f32 body), at J=16 and three occupancies, with
   every kernel's launch count read around that run; then where /
   compact / kernel step times; [profile] the idle share of one LeNet
   pool step and one kernel-mode step;
7. [train-lm] the transformer sweep: ``run_sweep`` over StableLM-2 1.6B at
   its published width with the depth cut to 4 layers (the cut is logged),
   8 tasks of skewed budgets on a refilled lane pool whose pack factor
   ``auto_nppn`` picks from measured bytes within 60 % of the card's
   memory; B3's launches read around the sweep (2 a layer a pool step and
   a probe step: the forward, and remat's recompute in the backward), the
   per-task losses against the same sweep through ``sdpa_chunked`` and
   the gaps of its rounding-only twin (``sdpa_chunked`` with P·V in bf16),
   what remat holds from forward to backward and the peaks of the gradient
   and of a pool step with and without remat, at the sweep's pack factor
   and at one lane of 8,192 tokens, [profile] one pool step; then
   on the reduced StableLM-2 a drain resumed at ``max_pack=2``, an
   ``adaptive_pack`` sweep and the card's losses against the CPU's;
   [train-resnet] the paper's §III-B ladder: ResNet-18 (width 1.0, 224 px,
   1000 classes) under ``packing.packed_step`` with SGD at NPPN 1, 2, 4
   and 6, 12 tasks in ceil(12 / NPPN) waves of 2 steps: individual time,
   job elapsed, speedup, bytes(1) x NPPN against the measured peak, each
   lane's losses against its task run alone, [profile] one pool step at
   NPPN 6;
   [train-moe] and [train-hybrid]: ``run_sweep`` over DeepSeekMoE-16B
   (routed dispatch) and Zamba2-7B at their published widths, remat on,
   AdamW, 4 tasks of skewed budgets on a refilled pool, the depth the
   deepest of two at which ``auto_nppn`` packs 2 lanes within 85 % of the
   card (logged): B3's launches read around the sweep (2 an attention
   block a pool step and a probe step: the forward and remat's recompute;
   no B4 launch, a Mamba2 block trains through the chunked scan), each
   task's losses against the task run alone, one lane's gradient (the
   router's, with the aux term, or the shared block's) nonzero, remat's
   one-lane held and gradient bytes against remat off, [profile] one pool
   step (with the f32 expert casts' share for the moe); [roofline]
   ``IntensityProfile.from_step`` of a 4-lane StableLM-2 decode step and
   of one [train-moe] pool step, counted on the card and on ``meta``
   (equal FLOPs and bytes), each report's row beside the step's measured
   time, the decode step the more memory-bound, both profiles recorded by
   admission through ``TriplesScheduler.submit(intensity_profile=...)``;
8. the policy and durability layer on the paper's LLMapReduce use, a
   parametric study scoring 10 prompts of 1,024 tokens (each item's mean
   NLL) with full-width, full-depth StableLM-2 1.6B, B3's launches read
   around each phase (all on the wgmma body): [mapreduce] ``llmapreduce``
   packed on a 4-slot pool (3 pool steps, one step program, 3 × 24
   launches) and slotted through ``TriplesScheduler`` (10 × 24), their
   losses within 5e-3 of each other, ``reduce_fn``, each path's items/s
   and a [profile] of both; [sched] ``TriplesScheduler`` under
   ``Tenancy`` on one node of this card, lanes measured by
   ``memory_per_lane``: a gang rejected by admission, tenant B preempting
   A (cursor files through the ``Checkpointer``), A resuming without
   re-running a task, results bit-equal to the slotted pass;
   [controlplane] a ``ControlPlane`` run uncrashed, then crashed at a
   middle record boundary and recovered: equal results, no decision-log
   difference, at most one task run twice; [replay] the port's
   ``compare_modes`` over the six committed traces against
   ``BENCH_HISTORY.json``'s last entry, every field exactly;
9. the distributed layer: the meta twins count in a child process on
   ``meta`` in a ``"fake"`` process group; then, with no child running,
   on a NCCL group of one rank and a (1, 1) mesh, [dist-ep] the longest
   [serve-moe] prefill under expert parallelism (f32 and bf16 combine):
   logits bit-equal to ``ParallelCtx()``'s, B3 14 launches each held to
   its plain version, the card's collectives equal to the same step's on
   ``meta``, then 8 decode steps under EP routed row by row, bit-equal;
   [dist-ssm] full mamba2-130m, [serve-ssm]'s longest prompt and 8
   decode steps with params and cache as DTensors (B4 and the state
   update under ``local_map``), logits and final cache bit-equal to
   ``ParallelCtx()``'s, B4 24 launches each held to its plain version on
   its served inputs, the card's peak beside the meta twins';
   [dist-train] 3 AdamW steps of full-width StableLM-2 (4 layers) with
   FSDP placements, bit-equal to the same steps unsharded by
   ``torch.autograd`` (or the first differing op named and held within
   1e-5), step 0's gradients in f32 compute within 1e-5 of each leaf's
   largest entry of the unsharded ``torch.func`` route's and bit-equal
   to them in bf16 compute, 24 B3 launches, ``compressed_psum`` and
   ``allgather_matmul`` at world size 1, the peak beside the meta
   count's whole peak (outputs included); then [dryrun]: ten full-size
   production cells, each a
   ``python -m repro_torch.launch.dryrun`` child, all started together:
   every cell OK, argument bytes two ways equal, pod-axis bytes on the
   multi-pod cells, each cell's temp (outputs left out) within twice the
   reference's and its TFLOP within 1.25 times, the four decode cells'
   collectives within twice the reference's, its outputs' bytes
   logged;
10. [examples] the four entry scripts ``examples/torch_*.py`` on the card
   as child processes at the reference's CI sizes (quickstart and
   serve_batch as they are, parametric_sweep ``--tasks 2 --steps 3``,
   train_lm ``--steps 20`` with its checkpoint under ``build/``), each
   exiting 0, their lines logged.

The last three lines of standard output are the ``nvidia-smi`` name/power
line, a JSON object with one record per kernel (each with its bodies'
registers, spill bytes and shared memory per CTA at the record's shape,
read from the built libraries), and the result line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

# kernel vs plain version. f32: allclose at rtol = atol = 2e-5 (two
# summation orders). bf16: both compute in f32 and round the output to
# bf16; outputs are softmax averages of N(0,1) values, |o| < 4, where one
# bf16 ulp is at most 2^-6 = 0.0156, so the max-abs bound is 2e-2
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_MAX_ABS = 2e-2
# full-width bf16 prefill logits (~unit scale) with the kernel vs with the
# plain version: 24 layers of bf16 rounding on both sides (StableLM-2)
LOGIT_ATOL_BF16 = 0.25
# the same for mamba2-130m, whose random-weight logits are narrower: logit
# std 0.557 and top-2 gap 0.234 at the compared prefill, where the kernel
# and the plain SSD read 0.0654 apart (PERF.md, section 6); 0.1 keeps a
# margin of 1.5x over that reading and stays below the top-2 gap
SSM_LOGIT_ATOL_BF16 = 0.1
SMALL_LOGIT_ATOL_F32 = 1e-4
# Zamba2-7B runs 94 blocks (81 Mamba2, 13 shared attention), and its
# random-weight bf16 logits (std 0.994) move by more than LOGIT_ATOL_BF16
# under a change of f32 summation order alone. On an NVIDIA H100 80GB HBM3
# at 700 W, at [serve-hybrid]'s compared prompt: kernels vs plain 0.2994,
# the bf16 plain route against its own f32 evaluation 0.3622, while in f32
# the kernels and the plain versions agree within 7.1e-5 at full depth.
# The bf16 gate is a constant above the sound reading; each B3 and B4 call
# of that prefill is held to [kernel]'s limits on its served inputs
# (``served_kernel_checks``), which is what catches a body that is off in
# a few heads. The f32 comparison is held to DEEP_LOGIT_ATOL_F32: 14x its
# reading, far below one bf16 rounding
HYBRID_LOGIT_ATOL_BF16 = 0.4
DEEP_LOGIT_ATOL_F32 = 1e-3
# gradients through the kernel path against the chunked path (f32): both
# backwards recompute through plain PyTorch, and the loss is quadratic in
# the output, so the kernel's forward enters them; sums over S terms in
# another order, the reference's own gradient bound (tests/test_ssm_
# attention.py, tests/test_torch_flash_attention.py GRAD_TOL)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# the same in bf16 (q, k, v and their gradients bf16): both backwards are
# sdpa_chunked's, so the gradients differ only through the cotangent
# 2·out·w, whose out the two forwards round apart by up to one bf16 ulp
# (2^-8 relative), and by the gradients' own rounding to bf16: held at
# 2^-5 (8 ulps) of the largest gradient; a forward that drops a mask moves
# the cotangent, and so the gradients, by O(1) of their scale
BF16_GRAD_REL = 2.0 ** -5
# packed GEMM and RMSNorm vs their plain versions. f32: F32_TOL (two
# summation orders). bf16: both compute in f32 and round the output once,
# so they may land one bf16 ulp apart; an ulp is at most 2^-7 of the value,
# so |kernel - plain| <= 2^-7 |plain| + 1e-3 elementwise
BF16_ULP_REL = 2.0 ** -7
BF16_ULP_ABS = 1e-3
# LeNet-4 per-task losses, "where" vs "compact" and a resume at capacity 4
# vs the uninterrupted run: cuBLAS may pick another algorithm for another
# batch count (ROADMAP C3), so allclose, with the bit-equal count printed
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
# kernel-mode pool state vs "where" mode: another program computes the
# step (the reference's own bound, benchmarks/bench_kernels.py:124)
MODE_TOL = dict(rtol=2e-5, atol=2e-5)

# SSD scan vs its plain version: sums of up to Q·N + Q·hd f32 products in
# another order, cancelling to small entries beside large ones, so the bound
# is on the output's scale: max |kernel - plain| <= 1e-5 · max(1, max |plain|)
# (the CPU tests' bound against the reference). A bf16 y may also land one
# bf16 ulp away: <= 2^-7 |plain| on top, elementwise
SSD_SCALED = 1e-5

N_LAYERS_FULL = 24
# (b, S, nh, hd, N, chunk) of one mamba2-130m prefill of 1024 tokens
SSD_SERVE = (1, 1024, 24, 64, 128, 128)
# the same for a zamba2-7b prefill of 1024 tokens (each of its 81 Mamba2
# layers)
SSD_HYBRID = (1, 1024, 112, 64, 64, 128)
# kernel shapes (J, M, K, N) and (J, rows, d): the lane pool's kernel-mode
# step (J=16, d=o=nb=256, benchmarks/bench_kernels.py:164-166), one
# StableLM-2 MLP up-projection per lane, and one StableLM-2 row norm
POOL_GEMM = (16, 256, 256, 256)
MLP_GEMM = (4, 512, 2048, 5632)
POOL_NORM = (16, 256, 256)
WIDE_NORM = (4, 2048, 2048)
ROW_NORM = (1, 1024, 2048)
# a row longer than the RMSNorm kernels' register routine holds (a 7B-class
# model's width): it takes the two-read routine in bf16 and f32
LONG_NORM = (2, 64, 4096)
# the kernel-mode pool: J, d, o, nb (benchmarks/bench_kernels.py:164-166)
KERNEL_POOL = (16, 256, 256, 256)
LENET_BATCH = 64            # the paper's batch (§III-A)

# [train-lm]: StableLM-2 1.6B at its published width with the depth cut
# from 24 to 4 layers. A lane holds params, grads and two AdamW moments in
# f32, 16 B a parameter: at 24 layers (1.645 B params) that is 26 GB a
# lane and two lanes fill the card; at 4 layers (617 M params) 9.9 GB
TRAIN_LM_LAYERS = 4
TRAIN_LM_BATCH, TRAIN_LM_SEQ = 2, 512
TRAIN_LM_BUDGETS = (2, 6, 3, 5, 2, 4, 6, 3)     # skewed per-task budgets
TRAIN_LM_LRS = tuple(float(x) for x in np.geomspace(1e-4, 3e-3, 8))
TRAIN_LM_HBM_FRACTION = 0.6  # hbm_budget: of the card's memory
# remat's peaks are read once more at one lane of 8,192 tokens (16 x 512),
# the tokens of a 2 x 4096 micro-batch at StableLM-2's training context:
# there the blocks' activations (about 0.11 MB a token a layer, twice that
# with what the backward keeps) outweigh AdamW's five copies of the params
# (12.3 GB), so without remat the gradient sets the pool step's peak
TRAIN_LM_REMAT_TOKENS = 8192
# per-task losses through B3 against the same sweep through sdpa_chunked,
# both bf16 compute on the card. Step 0 (the same params, only the forward
# differs): the two attention paths round their bf16 outputs apart by
# about one bf16 ulp (2^-8 relative), which reaches a mean token loss of
# about log V = 11.5 through 4 layers; a relative gap above 5e-3 (about
# 1.3 bf16 ulps, 0.06 at 11.5) would mean the paths compute something
# else. Later steps: AdamW's first update moves each weight by about
# lr·sign(g), so a weight whose gradient two roundings of the same
# function give opposite signs moves 2·lr apart, and the trajectories
# part by more than rounding. The run shows it with a rounding-only twin,
# sdpa_chunked with P·V in bf16 against f32 P: on an H100 it parts from
# sdpa_chunked by 5.2e-4 at step 0 and by up to 0.084 later, B3 by 5.8e-4
# and 0.20 (1.5 % at a loss of 13.6), both first at step 2 and in the
# tasks of lr >= 1.1e-3. Held at 5 %: 3x B3's reading, 7x the twin's
TRAIN_LM_LOSS_RTOL = 5e-3
TRAIN_LM_TRAJ_RTOL = 5e-2
# the reduced model's per-task losses, card against CPU (f32 both, the
# kernel's f32 body against sdpa_chunked, other GEMM orders): the [small]
# phase's logit bound
XDEV_LOSS_TOL = dict(rtol=1e-4, atol=1e-4)

# [train-moe] and [train-hybrid]: DeepSeekMoE-16B and Zamba2-7B at their
# published widths, remat on, AdamW, 4 tasks of skewed budgets on a
# refilled pool. A lane holds f32 params, grads and two moments (16 B a
# param), and a pool step holds its lanes' old and new state at once:
# [train-lm]'s bytes(1), 19.73 GB, was twice its lane's 9.87 GB on an H100.
# The depth is the deepest of these at which auto_nppn packs 2 lanes within
# TRAIN_FAMILY_HBM_FRACTION of the card (tried in order; the phase fails
# if none does): DeepSeekMoE 1 layer is 1.007 B params (the embedding and
# head of 102,400 x 2048 are 419 M of them), 2 layers 1.595 B; Zamba2 9
# layers (one superblock of 6 Mamba2 blocks and the shared block, and a
# tail of 3) 1.137 B, 6 layers (no tail) 0.903 B. The budget leaves room
# for what the probe does not hold: run_sweep's template (one lane's
# params) and the allocator's fragmentation (5.23 GiB reserved and
# unallocated when a 2-lane DeepSeekMoE pool packed at 90 % ran out of
# memory, its executor then still holding a finished lane's copy)
TRAIN_FAMILY_DEPTHS = {"deepseek-moe-16b": (2, 1), "zamba2-7b": (9, 6)}
TRAIN_FAMILY_HBM_FRACTION = 0.85
TRAIN_FAMILY_BUDGETS = (2, 3, 1, 2)
TRAIN_FAMILY_LRS = (1e-4, 3e-4, 1e-3, 3e-3)
# [roofline]: the decode step's 4 lanes sit after a prompt of this many
# tokens ([serve]'s longest prompts are of this order)
ROOFLINE_PROMPT = 512

# phase 8: the parametric study scores 10 prompts of 1,024 tokens (numpy
# seed 0) on full-width, full-depth StableLM-2 1.6B over a triples placement
# of 4 slots
STUDY_ITEMS, STUDY_SEQ = 10, 1024
STUDY_TRIPLES = (1, 4, 1)
# the throughput of each path is timed on a longer study of 40 prompts (10
# pool steps packed; 0.8 and 2.2 s of wall on an H100), the first 10 of
# them the gated items: 10 items are 0.2-0.6 s, where the host's noise
# moved the packed/slotted ratio from 1.5x to 2.6x between calls
STUDY_TIMING_ITEMS = 40
# per-item losses packed (4 lanes folded into B3's batch) against slotted
# (batch 1): on an H100 they agreed within 7.9e-8 relative; the items'
# losses (all near log V) differ from each other by up to 5.1e-3 relative,
# so the limit sits far under that spread and 100x over the reading, room
# for cuBLAS to pick another algorithm at another batch (ROADMAP C3); each
# packed loss must also lie nearest its own item's slotted loss
STUDY_LOSS_RTOL = 1e-5

# [train-resnet]: the paper's §III-B ladder (benchmarks/bench_imagenet_
# sharing.py:28-31,57): 12 tasks at NPPN 1, 2, 4, 6, 2 steps a wave; the
# per-lane batch starts at 16 (the paper's 256 images at 224 px do not fit
# six lanes) and is the largest power of two whose measured bytes(1) x 6
# fits TRAIN_LM_HBM_FRACTION of the card
RESNET_TASKS, RESNET_STEPS = 12, 2
RESNET_NPPN = (1, 2, 4, 6)
RESNET_BATCH = 16
# each lane's loss packed against the same task alone: the CPU test's
# tolerance (tests/test_torch_resnet.py TOL); cuDNN may pick other
# algorithms for another lane count (ROADMAP C4), so not bits
RESNET_LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(fn, iters: int = 1, with_cpu: bool = False) -> list:
    """The device (kernel) events of ``iters`` calls of ``fn`` in a
    torch.profiler trace. A trace that holds no device event is taken
    again, up to three traces in all: CUPTI on the card's machine now and
    then returns an empty trace, which must not read as zero device time.
    Raises if all three are empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if with_cpu
                                      else [])
    for attempt in range(1, 4):
        with profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
        log(f"[profile] trace {attempt} of 3 holds no device event")
    raise AssertionError("torch.profiler recorded no kernel on the card in "
                         "three traces")


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call: the summed durations of the kernels it
    launches, from a torch.profiler trace of ``iters`` warm calls. Unlike
    ``cuda_time_ms`` it leaves out the host's launch overhead, which sets
    the event time of a short kernel behind a Python wrapper."""
    import torch
    fn()
    torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in device_events(fn, iters))
    return us / 1e3 / iters


# ---------------------------------------------------------------------------
# phase 1: set-up
# ---------------------------------------------------------------------------

def setup() -> tuple:
    """Builds the kernels, checks their SASS, reads the card; returns the
    card's ``nvidia-smi`` line and the ``ptxas`` logs of the libraries this
    run compiled, by library."""
    import torch
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {sorted(logs) or 'cached'} in "
        f"{time.perf_counter() - t0:.1f} s")
    check_sass()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[card] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card, logs


# the libraries that run on the tensor cores, with the SASS instructions
# counted in each and those it must hold: B1's and B3's bf16 bodies use
# wgmma (HGMMA) fed by TMA (UTMALDG) behind mbarriers (SYNCS); B4 uses
# mma.sync (HMMA) on ldmatrix (LDSM) fragments of tiles copied by cp.async
# (LDGSTS)
TENSOR_CORE_LIBS = {"packed_gemm": (("HGMMA", "UTMALDG", "SYNCS"),
                                    ("HGMMA", "UTMALDG")),
                    "flash_attention": (("HGMMA", "UTMALDG", "SYNCS"),
                                        ("HGMMA", "UTMALDG")),
                    "ssd_scan": (("HMMA", "LDGSTS", "LDSM"),
                                 ("HMMA", "LDGSTS"))}


def check_sass() -> None:
    """Counts the tensor-core and copy instructions of each library in
    ``TENSOR_CORE_LIBS`` in its compiled code; fails if a library lacks one
    it must hold."""
    from repro_torch.analysis import kernel_report
    from repro_torch.kernels import _build
    tool = kernel_report.cuobjdump()
    for name, (ops, needed) in TENSOR_CORE_LIBS.items():
        sass = subprocess.run(
            [tool, "-sass", str(_build.library_path(name))], check=True,
            capture_output=True, text=True, timeout=120).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}
        log(f"[build] {name} SASS: {counts}")
        missing = [op for op in needed if not counts[op]]
        if missing:
            raise AssertionError(f"{name}: no {', '.join(missing)} in its "
                                 f"SASS")


# the __global__ kernels behind each record of the kernels JSON line, by body
RECORD_BODIES = {
    "flash_attention_fwd": {"simt": "fa_fwd_simt_kernel",
                            "wgmma": "fa_fwd_wgmma_kernel"},
    "packed_gemm": {"simt": "gemm_simt_kernel",
                    "wgmma": "gemm_wgmma_kernel"},
    "packed_rmsnorm": {"row": "packed_rmsnorm_kernel"},
    "fused_rmsnorm": {"row": "fused_rmsnorm_kernel"},
    "ssd_scan": {"chunk": "ssd_chunk_kernel", "state": "ssd_state_kernel",
                 "out": "ssd_out_kernel"},
}


def launch_smem(kernel: str, dims: dict) -> int:
    """The dynamic shared memory, in bytes, that ``kernel``'s launch passes
    at ``dims``, asked of its library: B3's at head dim ``dims["D"]``, B1's
    by body, B4's from the plan of the call ``dims["ssd"]`` (b, S, nh, hd,
    N, chunk, dtype). The RMSNorm kernels and ``ssd_state_kernel`` are
    launched with none (``<<<..., 0, ...>>>`` in their sources)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import packed_gemm as pg
    from repro_torch.kernels import ssd_scan
    if kernel.startswith("fa_fwd_"):
        return fa.launch_smem(kernel.split("_")[2], dims["D"])
    if kernel.startswith("gemm_"):
        return pg.launch_smem(kernel.split("_")[1])
    if kernel in ("ssd_chunk_kernel", "ssd_out_kernel"):
        plan = ssd_scan.plan(*dims["ssd"], torch.cuda.current_device())
        return plan.smem[kernel.split("_")[1]]
    return 0


def nominal_dims(nominal: dict) -> dict:
    """``launch_smem``'s dims for a budget's nominal bindings: the head dim,
    and B4's plan call read from its ``make_plan(...)`` text (its last
    argument is the dtype code, 1 for bf16)."""
    import torch
    dims = {"D": nominal.get("D")}
    if "pl" in nominal:
        *shape, code = (int(x) for x in re.findall(r"\d+", nominal["pl"]))
        dims["ssd"] = (*shape, {0: torch.float32, 1: torch.bfloat16}[code])
    return dims


def analysis(logs: dict) -> list:
    """[analysis]: the contract lint over the tree (0 findings against the
    empty baseline), the static kernel report (every masked kernel gated
    before its first load), every kernel instantiation of this run's
    libraries within its budgets (``logs``: setup()'s ``ptxas`` logs), and
    each kernel's shared memory per CTA at its budget's nominal dims read
    from the library (static shared memory from ``cuobjdump``, without the
    runtime's reserved 1 KB, plus the dynamic size its launch function
    gives) against the model's. Returns the instantiation rows."""
    from repro_torch.analysis import kernel_report as kr
    from repro_torch.analysis.config import default_config
    from repro_torch.analysis.driver import run_lint
    from repro_torch.roofline.budgets import RESERVED_SMEM
    t0 = time.perf_counter()
    cfg = default_config(root=str(Path(__file__).resolve().parent))
    lint = run_lint(cfg)
    for f in lint.active:
        log(f"[analysis] {f.render()}")
    assert lint.ok and not lint.active, "the contract lint has findings"
    log(f"[analysis] lint: clean, {len(lint.modules)} files, "
        f"{len(lint.suppressed)} pragma-suppressed, baseline "
        f"{Path(cfg.baseline_path).name} empty")
    rep = kr.build_report(cfg)
    problems = kr.check_static(rep, lint)
    sources = {src.relpath: src for src in kr.load_sources(cfg)}
    rows = kr.read_libraries(logs)
    problems += kr.check_libraries(rows, list(sources.values()), cfg)
    for line in kr.format_rows(rows):
        log(f"[analysis] {line}")
    for k in rep["kernels"]:
        mine = [r for r in rows if r["kernel"] == k["kernel"]]
        log(f"[analysis] {k['path'].rsplit('/', 1)[-1]}:{k['line']} "
            f"{k['kernel']}: {len(mine)} instantiation(s), lane predicate "
            f"{k['lane_predicate']}, gated before its first load "
            f"{k['gated_before_load']}, grids "
            f"{[ln['grid_rank'] for ln in k['launches']]} for axes "
            f"{''.join(k['block_axes'])}")
        if not mine:
            continue
        nominal = cfg.kernel_budgets[f"{k['path']}::{k['kernel']}"]["nominal"]
        reserved = RESERVED_SMEM if sources[k["path"]].uses_shared() else 0
        static = max(r["shared"] for r in mine) - reserved
        dynamic = launch_smem(k["kernel"], nominal_dims(nominal))
        log(f"[analysis] {k['kernel']}: shared memory per CTA at nominal "
            f"dims {nominal}: the library's {static} B static + {dynamic} B "
            f"its launch passes = {static + dynamic} B; modelled "
            f"{k['smem_bytes']} B (budget {k['smem_budget']} B)")
        if static + dynamic != k["smem_bytes"]:
            problems.append(f"{k['kernel']}: the library's shared memory "
                            f"{static + dynamic} B at nominal dims, the "
                            f"model's {k['smem_bytes']} B")
    for p in problems:
        log(f"[analysis] problem: {p}")
    assert not problems, f"{len(problems)} kernel-report problem(s)"
    log(f"[analysis] kernel report: {rep['n_kernels']} kernels, "
        f"{len(rows)} instantiations within budgets, "
        f"{sum(1 for r in rows if r['spill_stores'] is not None)} with spills "
        f"read from this run's ptxas log, in "
        f"{time.perf_counter() - t0:.1f} s")
    return rows


def attach_resources(records: list, rows: list) -> None:
    """Each record of the kernels JSON line gains, by body, what this run
    read of its kernel in the built libraries ([analysis]'s ``rows``):
    ``registers``, the most of any instantiation; ``spill_bytes``, their sum
    in this run's ``ptxas`` log (None on a cached build); and ``smem_bytes``
    per CTA at the record's shape: the library's static shared memory (the
    runtime's reserved 1 KB included) plus the dynamic size the launch
    passes there, asked of the library (B4's from the record's plan)."""
    for rec in records:
        for key in ("registers", "spill_bytes", "smem_bytes"):
            rec[key] = {}
        for body, kernel in RECORD_BODIES[rec["name"]].items():
            mine = [r for r in rows if r["kernel"] == kernel]
            spills = [r["spill_stores"] + r["spill_loads"] for r in mine
                      if r["spill_stores"] is not None]
            if rec["name"] == "ssd_scan":
                dynamic = rec["plan"]["smem"].get(body, 0)
            else:
                dynamic = launch_smem(kernel, {"D": rec.get("shape", [0])[-1]})
            rec["registers"][body] = max(r["registers"] for r in mine)
            rec["spill_bytes"][body] = (sum(spills) if len(spills) == len(mine)
                                        else None)
            rec["smem_bytes"][body] = max(r["shared"] for r in mine) + dynamic


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

def bound_ms(flops: float, nbytes: float, peak_flops: float):
    """The least time for the work: the larger of the operations at the
    peak rate and the bytes (each input read once, each output written
    once) at the memory rate. Returns (ms, what sets it)."""
    t_ops = flops / peak_flops
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_wrappers() -> dict:
    """Every kernel's CUDA wrapper (each carries a ``launches`` count), by
    the name the kernels JSON gives it."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_rmsnorm as rn
    from repro_torch.kernels import packed_gemm as pg
    from repro_torch.kernels import ssd_scan as sd
    return {"flash_attention_fwd": fa.flash_attention_cuda,
            "packed_gemm": pg.packed_gemm_cuda,
            "packed_rmsnorm": rn.packed_rmsnorm_cuda,
            "fused_rmsnorm": rn.fused_rmsnorm_cuda,
            "ssd_scan": sd.ssd_scan_cuda}


def reset_launches() -> None:
    """Every count to 0: launches, launches by body, and B4's calls with
    scalar row reads."""
    for fn in kernel_wrappers().values():
        fn.launches = 0
        for body in getattr(fn, "launches_by_body", {}):
            fn.launches_by_body[body] = 0
        if hasattr(fn, "scalar_reads"):
            fn.scalar_reads = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def attention_bound_ms(B, Sq, Sk, Hq, Hkv, D, causal, window, dtype):
    """Least time for the function on these inputs: the larger of the FLOPs
    of the unmasked (q, k) pairs at the dtype's peak and the bytes of q, k,
    v read once and o written once at the memory rate
    (``roofline.counting.attention_work``, which counts a step's B3
    calls)."""
    from repro_torch.roofline.counting import attention_work
    return bound_ms(*attention_work(B, Sq, Sk, Hq, Hkv, D, causal, window,
                                    dtype.itemsize), PEAK_FLOPS[str(dtype)])


def _qkv(gen, B, Sq, Sk, Hq, Hkv, D, dtype):
    import torch
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    return mk(B, Sq, Hq, D), mk(B, Sk, Hkv, D), mk(B, Sk, Hkv, D)


def check_flash_attention() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch import configs
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    vlm = configs.get("qwen2-vl-7b")
    s_vlm = max(r.S for r in vlm_requests(vlm.vocab_size, vlm.d_model))
    # (name, B, Sq, Sk, Hq, Hkv, D, dtype, causal, window)
    cases = [
        ("prefill", 1, 1024, 1024, 32, 32, 64, bf16, True, 0),
        ("gqa_window", 2, 777, 777, 32, 4, 128, bf16, True, 256),
        ("f32_gqa_causal", 2, 200, 200, 8, 2, 64, f32, True, 0),
        ("f32_bidir", 1, 256, 256, 4, 4, 128, f32, False, 0),
        ("f32_cross_ragged", 1, 100, 333, 8, 8, 64, f32, False, 0),
        ("f32_cross_causal", 2, 130, 70, 4, 2, 128, f32, True, 0),
        ("f32_bidir_window", 1, 200, 200, 4, 2, 64, f32, False, 48),
        # the same masks and edges on the bf16 (wgmma) body
        ("bidir", 1, 256, 256, 4, 4, 128, bf16, False, 0),
        ("cross_ragged", 1, 100, 333, 8, 8, 64, bf16, False, 0),
        ("cross_causal", 2, 130, 70, 4, 2, 128, bf16, True, 0),
        ("bidir_window", 1, 200, 200, 4, 2, 64, bf16, False, 48),
        # head dim 16 (every reduced config, f32) and 112 (zamba2-7b: 32
        # heads, bf16), the box's columns past D zero-filled in bf16
        ("f32_d16_causal", 2, 300, 300, 4, 2, 16, f32, True, 0),
        ("f32_d16_window", 1, 200, 200, 4, 4, 16, f32, True, 48),
        ("f32_d16_bidir", 1, 130, 70, 4, 2, 16, f32, False, 0),
        ("d112_causal", 1, 1024, 1024, 32, 32, 112, bf16, True, 0),
        # [serve-moe]'s prefill: DeepSeekMoE-16B, 16 heads of 128
        ("moe_prefill", 1, 1024, 1024, 16, 16, 128, bf16, True, 0),
        ("d112_window", 1, 777, 777, 32, 32, 112, bf16, True, 256),
        ("d16_causal", 2, 300, 300, 4, 2, 16, bf16, True, 0),
        # [train-lm]'s pool step: 2 lanes of batch 2 folded into B
        ("train_lm", 4, 512, 512, 32, 32, 64, bf16, True, 0),
        # [mapreduce]'s packed study: 4 lanes of (1, 1024) folded into B
        ("study_packed", 4, 1024, 1024, 32, 32, 64, bf16, True, 0),
        # [serve-vlm]'s longest prefill: Qwen2-VL-7B, 28 query heads on 4 KV
        # heads (groups of 7) of 128; [serve-encdec]'s encoder at its
        # longest request: SeamlessM4T-medium, 16 heads of 64, bidirectional
        ("vlm_prefill", 1, s_vlm, s_vlm, 28, 4, 128, bf16, True, 0),
        ("encoder", 1, 1024, 1024, 16, 16, 64, bf16, False, 0),
    ]
    errs = {}
    for name, B, Sq, Sk, Hq, Hkv, D, dt, causal, window in cases:
        q, k, v = _qkv(gen, B, Sq, Sk, Hq, Hkv, D, dt)
        out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        errs[name] = err
        if dt == f32:
            ok, tol = torch.allclose(out, ref, **F32_TOL), F32_TOL
        else:
            ok, tol = err <= BF16_MAX_ABS, f"max abs {BF16_MAX_ABS}"
        log(f"[kernel] flash_attention {name} {tuple(q.shape)}->"
            f"{tuple(k.shape)} {dt} causal={causal} window={window}: "
            f"max_abs_err {err:.3g} ({tol})")
        if not (ok and torch.isfinite(out).all()):
            raise AssertionError(f"flash_attention {name}: kernel disagrees "
                                 f"with its plain version (max err {err})")

    # lane mask: inactive lanes exact zeros, active lanes bit-identical
    active = torch.tensor([1, 0, 1, 0], device="cuda")
    for dt, D in ((bf16, 64), (bf16, 128), (f32, 128), (f32, 16),
                  (bf16, 112)):
        q, k, v = _qkv(gen, 4, 256, 256, 8, 4, D, dt)
        dense = fa.flash_attention_cuda(q, k, v, causal=True)
        masked = fa.flash_attention_cuda(q, k, v, causal=True, active=active)
        torch.cuda.synchronize()
        if not (torch.equal(masked[1], torch.zeros_like(masked[1]))
                and torch.equal(masked[3], torch.zeros_like(masked[3]))):
            raise AssertionError("flash_attention: inactive lanes not zero")
        if not (torch.equal(masked[0], dense[0])
                and torch.equal(masked[2], dense[2])):
            raise AssertionError("flash_attention: active lanes differ "
                                 "from the unmasked launch")
        log(f"[kernel] flash_attention masked {dt} D={D}: inactive lanes "
            f"exact zeros, active lanes bit-identical")

    check_attention_vmap_grad(gen)

    # timing at the serving path's prefill shape
    name, B, Sq, Sk, Hq, Hkv, D, dt, causal, window = cases[0]
    q, k, v = _qkv(gen, B, Sq, Sk, Hq, Hkv, D, dt)
    shape = list(q.shape)
    ms = cuda_time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    dev_ms = device_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    plain_ms = cuda_time_ms(
        lambda: fa.flash_attention_plain(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    library_ms = cuda_time_ms(sdpa)
    library_dev_ms = device_ms(sdpa)
    bound_ms, bound_by = attention_bound_ms(B, Sq, Sk, Hq, Hkv, D, causal,
                                            window, dt)
    log(f"[kernel] flash_attention {tuple(q.shape)} bf16 causal (wgmma "
        f"body): kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms (device "
        f"{library_dev_ms:.4f}), bound {bound_ms:.4f} ms ({bound_by})")
    # the prefill shapes of [serve-moe] (D 128), [serve-hybrid] (D 112),
    # [serve-vlm] (GQA 28/4, D 128) and [serve-encdec]'s encoder (not causal)
    shapes = {}
    for case in cases:
        if case[0] not in ("moe_prefill", "d112_causal", "vlm_prefill",
                           "encoder"):
            continue
        name, B, Sq, Sk, Hq, Hkv, D, dt, causal, window = case
        q, k, v = _qkv(gen, B, Sq, Sk, Hq, Hkv, D, dt)
        fn = lambda: fa.flash_attention_cuda(q, k, v, causal=causal)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv)
        t = {"name": name, "max_abs_err": errs[name], "ms": cuda_time_ms(fn),
             "device_ms": device_ms(fn),
             "plain_ms": cuda_time_ms(lambda: fa.flash_attention_plain(
                 q, k, v, causal=causal)),
             "library_ms": cuda_time_ms(sdpa),
             "library_device_ms": device_ms(sdpa)}
        t["bound_ms"], t["bound_by"] = attention_bound_ms(
            B, Sq, Sk, Hq, Hkv, D, causal, window, dt)
        log(f"[kernel] flash_attention {name} {tuple(q.shape)} Hkv {Hkv} "
            f"bf16 causal={causal} (wgmma body): kernel {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
            f"SDPA {t['library_ms']:.4f} ms (device "
            f"{t['library_device_ms']:.4f}), bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']})")
        shapes[str((B, Sq, Hq, D))] = t
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:159",
            "launches": None, "max_abs_err": errs["prefill"], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_device_ms": library_dev_ms, "shape": shape,
            "shapes": shapes}


def check_attention_vmap_grad(gen) -> None:
    """``torch.func.vmap(torch.func.grad(loss))`` through
    ``ops.flash_attention`` on the card, as a lane pool steps its lanes,
    against the same through ``sdpa_chunked``: 3 lanes of (2, 96, 4, 16)
    f32 with a shared lane mask (the simt body), and [train-lm]'s pool
    step, 2 lanes of (2, 512, 32, 64) bf16 causal (the wgmma body). Each
    vmapped call launches B3 exactly once (the lanes folded into its batch
    axis), on the body of its dtype, and the gradients agree: f32 within
    GRAD_TOL; bf16 within BF16_GRAD_REL of the largest gradient, with the
    vmapped forward within BF16_MAX_ABS of ``sdpa_chunked``'s. The loss is
    quadratic in the output, so the kernel's forward enters the
    gradient. Each case runs B3's backward in one query slice (these
    shapes fit its budget) and again in several (``BACKWARD_BLOCK_BYTES``
    cut to a quarter of the rows or less: 6 slices of 96 rows, 4 of
    512)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import sdpa_chunked
    f32_case = (3, 2, 96, 4, 2, 16, torch.float32,
                torch.tensor([1, 0], device="cuda"),
                ((True, 0), (True, 32), (False, 0)))
    bf16_case = (2, 2, 512, 32, 32, 64, torch.bfloat16, None, ((True, 0),))
    for lanes, B, S, Hq, Hkv, D, dt, active, masks in (f32_case, bf16_case):
        mk = lambda h: torch.randn(lanes, B, S, h, D, generator=gen,
                                   device="cuda").to(dt)
        q, k, v, w = mk(Hq), mk(Hkv), mk(Hkv), mk(Hq).float()
        body = "wgmma" if dt == torch.bfloat16 else "simt"
        whole = ops.BACKWARD_BLOCK_BYTES
        cut = (lanes * B * Hq * min(S, 1024) * 4
               * (1 << ((S // 4).bit_length() - 1)))
        for (causal, window), budget in itertools.product(masks,
                                                          (whole, cut)):
            def port(q, k, v):
                return ops.flash_attention(q, k, v, causal, window,
                                           active=active)

            def chunked(q, k, v):
                out = sdpa_chunked(q, k, v, causal=causal, window=window)
                return out if active is None else ref.mask_lanes(active, out)

            grads, outs = {}, {}
            for name, attend in (("kernel", port), ("chunked", chunked)):
                loss = lambda q, k, v, w: (attend(q, k, v).float() ** 2
                                           * w).sum()
                before = dict(fa.flash_attention_cuda.launches_by_body)
                ops.BACKWARD_BLOCK_BYTES = budget
                try:
                    slices = -(-S // ops.backward_rows(lanes * B, S, Hq,
                                                       min(S, 1024)))
                    grads[name] = torch.func.vmap(torch.func.grad(
                        loss, argnums=(0, 1, 2)))(q, k, v, w)
                finally:
                    ops.BACKWARD_BLOCK_BYTES = whole
                torch.cuda.synchronize()
                after = fa.flash_attention_cuda.launches_by_body
                launched = {b: after[b] - before[b] for b in after}
                want = {b: int(name == "kernel" and b == body) for b in after}
                if launched != want:
                    raise AssertionError(f"vmap(grad) through {name}: B3 "
                                         f"launches {launched}, want {want}")
                if dt == torch.bfloat16:
                    outs[name] = torch.func.vmap(attend)(q, k, v)
            errs = [(a - b).abs().max().item()
                    for a, b in zip(grads["kernel"], grads["chunked"])]
            finite = all(torch.isfinite(a).all() for a in grads["kernel"])
            if dt == torch.float32:
                ok = finite and all(
                    torch.allclose(a, b, **GRAD_TOL)
                    for a, b in zip(grads["kernel"], grads["chunked"]))
                tol = f"{GRAD_TOL}"
            else:
                scale = [b.abs().max().item() for b in grads["chunked"]]
                out_err = (outs["kernel"].float()
                           - outs["chunked"].float()).abs().max().item()
                ok = finite and out_err <= BF16_MAX_ABS and all(
                    e <= BF16_GRAD_REL * m for e, m in zip(errs, scale))
                tol = (f"<= {BF16_GRAD_REL} x max |grad| "
                       f"({', '.join(f'{m:.3g}' for m in scale)}); forward "
                       f"max_abs_err {out_err:.3g} (max abs {BF16_MAX_ABS})")
            log(f"[kernel] flash_attention vmap(grad) {lanes} lanes of "
                f"{(B, S, Hq, D)} {dt} causal={causal} window={window}, "
                f"backward in {slices} query slice(s): one "
                f"B3 launch per call ({body}), grad max_abs_err vs "
                f"sdpa_chunked {', '.join(f'{e:.3g}' for e in errs)} ({tol})")
            if not ok:
                raise AssertionError(f"vmap(grad) through B3 disagrees with "
                                     f"sdpa_chunked (max err {max(errs)})")


def _agree(out, ref) -> tuple:
    """(kernel agrees with its plain version, max abs error)."""
    import torch
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        ok = torch.allclose(out, ref, **F32_TOL)
    else:
        ok = bool((err <= BF16_ULP_REL * ref.float().abs()
                   + BF16_ULP_ABS).all())
    return ok and bool(torch.isfinite(out).all()), err.max().item()


def _tol_text(dtype) -> str:
    import torch
    return (f"rtol=atol={F32_TOL['rtol']}" if dtype == torch.float32
            else f"<= 2^-7|plain| + {BF16_ULP_ABS}")


def _check_lanes(masked, dense, active, what: str) -> None:
    import torch
    for lane, a in enumerate(active):
        want = dense[lane] if a else torch.zeros_like(dense[lane])
        if not torch.equal(masked[lane], want):
            raise AssertionError(f"{what}: lane {lane} (active={a}) is not "
                                 f"{'the dense result' if a else 'zeros'}")


def check_packed_gemm() -> dict:
    """B1 against its plain version at the reference test shapes, the pool
    step's shape and one StableLM-2 MLP up-projection per lane, through a
    transposed view, and lane-masked; in f32 (simt body) and bf16 (wgmma
    body). bf16 operands TMA cannot describe are copied (counted); at the
    pool and MLP shapes none may be. Then timed at the pool step's shape
    (f32, the record), at the same shape with x the gradient GEMM's x^T
    view (f32, the record's "xt"), and at the MLP shape (bf16, the record's
    "wgmma"), each beside ``torch.bmm`` on the same operands."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import packed_gemm as pg
    from repro_torch.roofline.counting import matmul_work
    gen = torch.Generator(device="cuda").manual_seed(1)
    mk = lambda *s, dt: torch.randn(*s, generator=gen, device="cuda").to(dt)
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {}
    for dt in (f32, bf16):
        for J, M, K, N in ((4, 64, 64, 64), (3, 50, 70, 30), (8, 128, 32, 16),
                           (1, 16, 16, 16), POOL_GEMM, MLP_GEMM):
            x, w = mk(J, M, K, dt=dt), mk(J, K, N, dt=dt)
            copies = pg.packed_gemm_cuda.padded_copies
            out = pg.packed_gemm_cuda(x, w)
            torch.cuda.synchronize()
            copies = pg.packed_gemm_cuda.padded_copies - copies
            ok, err = _agree(out, pg.packed_gemm_plain(x, w))
            errs[(J, M, K, N, str(dt))] = err
            log(f"[kernel] packed_gemm ({J},{M},{K},{N}) {dt} "
                f"({pg.gemm_body(dt)} body): max_abs_err {err:.3g} "
                f"({_tol_text(dt)}), padded copies {copies}")
            if not ok:
                raise AssertionError(f"packed_gemm ({J},{M},{K},{N}) {dt}: "
                                     f"kernel disagrees with its plain "
                                     f"version (max err {err})")
            if (J, M, K, N) in (POOL_GEMM, MLP_GEMM) and copies:
                raise AssertionError(f"packed_gemm ({J},{M},{K},{N}): "
                                     f"{copies} operands copied")
    # the gradient GEMM's x^T: a strided view, read without a copy
    for dt in (f32, bf16):
        x, e = mk(16, 256, 128, dt=dt), mk(16, 256, 64, dt=dt)
        xt = x.transpose(1, 2)
        copies = pg.packed_gemm_cuda.padded_copies
        out = pg.packed_gemm_cuda(xt, e)
        copies = pg.packed_gemm_cuda.padded_copies - copies
        ok, err = _agree(out, pg.packed_gemm_plain(xt, e))
        same = torch.equal(out, pg.packed_gemm_cuda(xt.contiguous(), e))
        log(f"[kernel] packed_gemm x^T view {tuple(xt.shape)} strides "
            f"{xt.stride()} {dt}: max_abs_err {err:.3g}, equal to the "
            f"contiguous copy {same}, padded copies {copies}")
        if not (ok and same and copies == 0):
            raise AssertionError(f"packed_gemm: transposed view disagrees "
                                 f"or was copied ({dt})")
    for dt in (f32, bf16):
        x, w = mk(4, 64, 64, dt=dt), mk(4, 64, 64, dt=dt)
        dense = ops.packed_matmul(x, w)
        for active in ((1, 0, 1, 0), (0, 0, 0, 1), (1, 1, 1, 1)):
            masked = ops.packed_matmul(x, w, active=torch.tensor(
                active, device="cuda"))
            _check_lanes(masked, dense, active, f"packed_gemm {dt}")
        log(f"[kernel] packed_gemm masked {dt}: inactive lanes exact zeros, "
            f"active lanes bit-identical, for (1,0,1,0) (0,0,0,1) (1,1,1,1)")

    timed = {}
    for label, (J, M, K, N), dt in (("pool step", POOL_GEMM, f32),
                                    ("pool step x^T", POOL_GEMM, f32),
                                    ("MLP up-projection", MLP_GEMM, bf16)):
        if label.endswith("x^T"):  # the gradient GEMM's operands: x^T a view
            x = mk(J, K, M, dt=dt).transpose(1, 2)
        else:
            x = mk(J, M, K, dt=dt)
        w = mk(J, K, N, dt=dt)
        ms = cuda_time_ms(lambda: pg.packed_gemm_cuda(x, w))
        dev_ms = device_ms(lambda: pg.packed_gemm_cuda(x, w))
        plain_ms = cuda_time_ms(lambda: pg.packed_gemm_plain(x, w))
        library_ms = cuda_time_ms(lambda: torch.bmm(x, w))
        library_dev_ms = device_ms(lambda: torch.bmm(x, w))
        b_ms, b_by = bound_ms(*matmul_work(J, M, K, N, dt.itemsize),
                              PEAK_FLOPS[str(dt)])
        timed[label] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": library_ms,
                        "library_device_ms": library_dev_ms}
        log(f"[kernel] packed_gemm {label} ({J},{M},{K},{N}) {dt} strides "
            f"x {x.stride()} ({pg.gemm_body(dt)} body): kernel {ms:.4f} ms "
            f"(device {dev_ms:.4f}), plain {plain_ms:.4f} ms, torch.bmm "
            f"{library_ms:.4f} ms (device {library_dev_ms:.4f}) on the same "
            f"operands, bound {b_ms:.4f} ms ({b_by})")
        if label.endswith("x^T"):
            ok, err = _agree(pg.packed_gemm_cuda(x, w),
                             pg.packed_gemm_plain(x, w))
            if not ok:
                raise AssertionError(f"packed_gemm {label}: kernel disagrees "
                                     f"(max err {err})")
            timed[label].update(max_abs_err=err, strides=list(x.stride()))
    mlp = dict(timed["MLP up-projection"], shape=list(MLP_GEMM),
               dtype="bfloat16",
               max_abs_err=errs[MLP_GEMM + ("torch.bfloat16",)])
    xt = dict(timed["pool step x^T"], shape=list(POOL_GEMM), dtype="float32")
    return {"name": "packed_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/packed_gemm.cu",
            "replaces": "src/repro/kernels/packed_gemm.py:69",
            "launches": None,
            "max_abs_err": errs[POOL_GEMM + ("torch.float32",)],
            **timed["pool step"], "wgmma": mlp, "xt": xt}


def _norm_bound(x, w) -> tuple:
    """RMSNorm (``roofline.counting.norm_work``): ~4 f32 operations per
    element; x and w read, out written."""
    from repro_torch.roofline.counting import norm_work
    d = x.shape[-1]
    return bound_ms(*norm_work(x.numel() // d, d, w.numel() // d,
                               x.element_size()), PEAK_FLOPS["torch.float32"])


def _routine(d: int, dtype) -> str:
    """Which row routine the RMSNorm kernels run for rows of d."""
    from repro_torch.kernels import fused_rmsnorm as rn
    vpl = rn.row_vectors(d, dtype)
    return f"registers, {vpl} vectors per lane" if vpl else "two reads"


def check_rmsnorm() -> list:
    """B2 and B5 against their plain versions, B2's masks, B2's active
    lanes against B5 on each slice bit for bit (rows held in registers,
    and rows longer than that, read twice), and their times. Returns
    the two records; their launches are those of the mask and identity
    checks, made through the entry points (``ops.packed_norm`` and
    ``fused_rmsnorm.fused_rmsnorm``), since neither kernel is on a path of
    the port yet."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_rmsnorm as rn
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(2)
    mk = lambda *s, dt: torch.randn(*s, generator=gen, device="cuda").to(dt)
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {}
    for dt in (f32, bf16):
        for J, rows, d in ((4, 16, 32), POOL_NORM, (3, 7, 100), WIDE_NORM,
                           LONG_NORM, (3, 7, 4100)):
            x, w = mk(J, rows, d, dt=dt), (1 + 0.1 * mk(J, d, dt=f32)).to(dt)
            out = rn.packed_rmsnorm_cuda(x, w)
            torch.cuda.synchronize()
            ok, err = _agree(out, rn.packed_rmsnorm_plain(x, w))
            errs[("packed", J, rows, d, str(dt))] = err
            log(f"[kernel] packed_rmsnorm ({J},{rows},{d}) {dt} "
                f"({_routine(d, dt)}): max_abs_err {err:.3g} "
                f"({_tol_text(dt)})")
            if not ok:
                raise AssertionError(f"packed_rmsnorm ({J},{rows},{d}) {dt}: "
                                     f"kernel disagrees (max err {err})")
        for shape in (ROW_NORM, (16, 32), (5, 7, 130), LONG_NORM[1:],
                      (7, 4100)):
            x, w = mk(*shape, dt=dt), (1 + 0.1 * mk(shape[-1], dt=f32)).to(dt)
            out = rn.fused_rmsnorm_cuda(x, w)
            torch.cuda.synchronize()
            ok, err = _agree(out, rn.fused_rmsnorm_plain(x, w))
            errs[("fused",) + shape + (str(dt),)] = err
            log(f"[kernel] fused_rmsnorm {shape} {dt} "
                f"({_routine(shape[-1], dt)}): max_abs_err {err:.3g} "
                f"({_tol_text(dt)})")
            if not ok:
                raise AssertionError(f"fused_rmsnorm {shape} {dt}: kernel "
                                     f"disagrees (max err {err})")

    reset_launches()
    for dt in (f32, bf16):
        x, w = mk(4, 256, 256, dt=dt), (1 + 0.1 * mk(4, 256, dt=f32)).to(dt)
        dense = ops.packed_norm(x, w)
        for active in ((1, 0, 1, 0), (0, 0, 0, 1), (1, 1, 1, 1)):
            masked = ops.packed_norm(x, w, active=torch.tensor(
                active, device="cuda"))
            _check_lanes(masked, dense, active, f"packed_rmsnorm {dt}")
        for j in range(4):
            if not torch.equal(dense[j], rn.fused_rmsnorm(x[j], w[j])):
                raise AssertionError(f"packed_rmsnorm {dt}: lane {j} differs "
                                     f"from fused_rmsnorm on its slice")
        log(f"[kernel] packed_rmsnorm masked {dt}: inactive lanes exact "
            f"zeros, active lanes bit-identical, every lane == fused_rmsnorm "
            f"on its slice bit for bit")
    launches = read_launches()
    # the same for rows longer than the register routine holds
    for dt in (f32, bf16):
        J, rows, d = LONG_NORM
        x, w = mk(J, rows, d, dt=dt), (1 + 0.1 * mk(J, d, dt=f32)).to(dt)
        dense = rn.packed_rmsnorm_cuda(x, w)
        masked = rn.packed_rmsnorm_cuda(x, w, active=torch.tensor(
            (0, 1), device="cuda"))
        _check_lanes(masked, dense, (0, 1), f"packed_rmsnorm {dt} d={d}")
        for j in range(J):
            if not torch.equal(dense[j], rn.fused_rmsnorm_cuda(x[j], w[j])):
                raise AssertionError(f"packed_rmsnorm {dt} d={d}: lane {j} "
                                     f"differs from fused_rmsnorm")
        log(f"[kernel] packed_rmsnorm masked {LONG_NORM} {dt} "
            f"({_routine(d, dt)}): inactive lane exact zeros, active lane "
            f"bit-identical, every lane == fused_rmsnorm bit for bit")

    records = []
    for label, (J, rows, d), dt in (("pool", POOL_NORM, f32),
                                    ("wide", WIDE_NORM, bf16),
                                    ("wide", WIDE_NORM, f32),
                                    ("long", LONG_NORM, bf16)):
        x, w = mk(J, rows, d, dt=dt), (1 + 0.1 * mk(J, d, dt=f32)).to(dt)
        ms = cuda_time_ms(lambda: rn.packed_rmsnorm_cuda(x, w))
        dev_ms = device_ms(lambda: rn.packed_rmsnorm_cuda(x, w))
        plain_ms = cuda_time_ms(lambda: rn.packed_rmsnorm_plain(x, w))
        b_ms, b_by = _norm_bound(x, w)
        log(f"[kernel] packed_rmsnorm {label} {tuple(x.shape)} {dt} "
            f"({_routine(d, dt)}): kernel {ms:.4f} ms (device {dev_ms:.4f}), "
            f"plain {plain_ms:.4f} ms, no library call (per-lane weights), "
            f"bound {b_ms:.4f} ms ({b_by})")
        if label == "pool":
            records.append({
                "name": "packed_rmsnorm", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                "replaces": "src/repro/kernels/fused_rmsnorm.py:76",
                "launches": launches["packed_rmsnorm"],
                "max_abs_err": errs[("packed",) + POOL_NORM
                                    + ("torch.float32",)],
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library_device_ms": None})
    x, w = mk(*ROW_NORM, dt=bf16), (1 + 0.1 * mk(ROW_NORM[-1], dt=f32)).to(
        bf16)
    ms = cuda_time_ms(lambda: rn.fused_rmsnorm_cuda(x, w))
    dev_ms = device_ms(lambda: rn.fused_rmsnorm_cuda(x, w))
    plain_ms = cuda_time_ms(lambda: rn.fused_rmsnorm_plain(x, w))
    rms_norm = lambda: F.rms_norm(x, (ROW_NORM[-1],), w, eps=1e-5)
    library_ms = cuda_time_ms(rms_norm)
    library_dev_ms = device_ms(rms_norm)
    b_ms, b_by = _norm_bound(x, w)
    log(f"[kernel] fused_rmsnorm {ROW_NORM} bf16 "
        f"({_routine(ROW_NORM[-1], bf16)}): kernel {ms:.4f} ms (device "
        f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, F.rms_norm "
        f"{library_ms:.4f} ms (device {library_dev_ms:.4f}), bound "
        f"{b_ms:.4f} ms ({b_by})")
    records.append({
        "name": "fused_rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/fused_rmsnorm.py:33",
        "launches": launches["fused_rmsnorm"],
        "max_abs_err": errs[("fused",) + ROW_NORM + ("torch.bfloat16",)],
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": library_ms,
        "library_device_ms": library_dev_ms})
    return records


def ssd_bound_ms(b, S, nh, hd, N, Q, itemsize) -> tuple:
    """Least time for the SSD scan: its f32 operations at the f32 peak,
    against its bytes."""
    from repro_torch.roofline.counting import ssd_work
    return bound_ms(*ssd_work(b, S, nh, hd, N, Q, itemsize),
                    PEAK_FLOPS["torch.float32"])


def ssd_tensor_core_bound_ms(b, S, nh, hd, N, Q, itemsize) -> tuple:
    """Least time for the same work on the route the kernel takes: each
    f32 product as three exact bf16 products at the bf16 tensor-core
    peak, against the same bytes."""
    from repro_torch.roofline.counting import ssd_work
    flops, nbytes = ssd_work(b, S, nh, hd, N, Q, itemsize)
    return bound_ms(3 * flops, nbytes, PEAK_FLOPS["torch.bfloat16"])


def check_ssd_plan(sd, dev: int) -> dict:
    """The plan the source gives at the serving shape, held to the design:
    192 CTAs in the chunk and output kernels for 132 SMs, two CTAs per SM
    in bf16 by the runtime's occupancy (one in f32), and one scratch of the
    log decays, C·Bᵀ once per chunk (512 KiB) and each chunk's (N, hd) f32
    state (6.3 MB)."""
    import torch
    b, S, nh, hd, N, Q = SSD_SERVE
    nc = S // Q
    pl = sd.plan(b, S, nh, hd, N, Q, torch.bfloat16, dev)
    pl32 = sd.plan(b, S, nh, hd, N, Q, torch.float32, dev)
    want = 4 * b * nc * (nh * Q + Q * Q + nh * N * hd)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"[kernel] ssd_scan plan {SSD_SERVE}: {b * nc * nh} CTAs per kernel "
        f"on {sms} SMs, scratch {4 * pl.scratch_floats} bytes, shared "
        f"memory {pl.smem} bytes (at most {pl.max_smem}), CTAs per SM "
        f"{pl.ctas_per_sm} bf16, {pl32.ctas_per_sm} f32 ({pl32.smem} bytes)")
    if 4 * pl.scratch_floats != want or b * nc * nh < sms \
            or set(pl.ctas_per_sm.values()) != {2} \
            or min(pl32.ctas_per_sm.values()) < 1:
        raise AssertionError(f"ssd_scan plan {pl} / {pl32} misses the "
                             f"design ({want} scratch bytes, two CTAs per "
                             f"SM)")
    return {"smem": pl.smem, "ctas_per_sm": pl.ctas_per_sm,
            "scratch_bytes": 4 * pl.scratch_floats}


def _ssd_inputs(gen, b, S, nh, hd, N, dtype, model_like: bool):
    """x, dt, A, B, C on the card. The reference's kernel test draws dt =
    softplus(N(0,1)) and A = -exp(N(0,1)); ``model_like`` draws what
    mamba2-130m's prefill sees: dt = softplus(N(0,1) - 3) (its dt_bias
    starts in [1e-3, 1e-1]) and A in [-16, -1] (its A_log init)."""
    import torch
    import torch.nn.functional as F
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x, B, C = mk(b, S, nh, hd), mk(b, S, N), mk(b, S, N)
    if model_like:
        dt = F.softplus(mk(b, S, nh) - 3.0)
        A = -(1.0 + 15.0 * torch.rand(nh, generator=gen, device="cuda"))
    else:
        dt = F.softplus(mk(b, S, nh))
        A = -torch.exp(mk(nh))
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype)


def _ssd_agree(out, ref) -> tuple:
    """(kernel agrees with its plain version, max abs error of y, of the
    state), under SSD_SCALED (and one bf16 ulp for a bf16 y)."""
    import torch
    ok, errs = True, []
    for got, want in zip(out, ref):
        err = (got.float() - want.float()).abs()
        scale = SSD_SCALED * max(1.0, want.float().abs().max().item())
        slack = (BF16_ULP_REL * want.float().abs()
                 if got.dtype == torch.bfloat16 else 0.0)
        ok = ok and bool((err <= slack + scale).all()) \
            and bool(torch.isfinite(got).all())
        errs.append(err.max().item())
    return ok, errs[0], errs[1]


def check_ssd_scan() -> dict:
    """B4 against its plain version in f32 and bf16: at a reference test
    shape, ragged chunks (9 and 10 steps), b = 4 and the serving prefill's
    shape; from a non-zero start state; through the model's strided views
    of one conv output; masked; then timed at the serving shape. Its launches are set by
    [serve-ssm] (``serve_family``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as sd
    gen = torch.Generator(device="cuda").manual_seed(4)
    f32, bf16 = torch.float32, torch.bfloat16
    plan = check_ssd_plan(sd, torch.cuda.current_device())
    errs = {}
    # (b, S, nh, hd, N, chunk, model-like inputs)
    cases = [(2, 128, 4, 16, 32, 32, False), (2, 96, 3, 16, 64, 32, False),
             (2, 9, 3, 16, 16, 32, False), (1, 30, 2, 16, 16, 10, False),
             (4, 512, 24, 64, 128, 128, True), SSD_SERVE + (True,),
             SSD_HYBRID + (True,)]
    for b, S, nh, hd, N, Q, model_like in cases:
        for dt in (f32, bf16):
            args = _ssd_inputs(gen, b, S, nh, hd, N, dt, model_like)
            out = sd.ssd_scan_cuda(*args, chunk=Q)
            torch.cuda.synchronize()
            ok, ey, es = _ssd_agree(out, sd.ssd_scan_plain(*args, chunk=Q))
            errs[(b, S, nh, hd, N, Q, str(dt))] = max(ey, es)
            log(f"[kernel] ssd_scan ({b},{S},{nh},{hd}) N={N} chunk={Q} {dt}"
                f"{' model-like' if model_like else ''}: max_abs_err y "
                f"{ey:.3g}, state {es:.3g} (<= {SSD_SCALED}·scale"
                f"{' + 2^-7|plain|' if dt == bf16 else ''})")
            if not ok:
                raise AssertionError(f"ssd_scan ({b},{S},{nh},{hd},{N},{Q}) "
                                     f"{dt}: kernel disagrees with its plain "
                                     f"version (y {ey}, state {es})")

    # a non-zero start state (the kernel's ``init`` input), plain and masked
    for b, S, nh, hd, N, Q in ((2, 96, 3, 16, 64, 32), SSD_SERVE):
        s0 = torch.randn(b, nh, hd, N, generator=gen, device="cuda")
        for dt in (f32, bf16):
            args = _ssd_inputs(gen, b, S, nh, hd, N, dt, True)
            out = sd.ssd_scan_cuda(*args, chunk=Q, init_state=s0)
            torch.cuda.synchronize()
            ok, ey, es = _ssd_agree(out, sd.ssd_scan_plain(
                *args, chunk=Q, init_state=s0))
            log(f"[kernel] ssd_scan ({b},{S},{nh},{hd}) N={N} chunk={Q} {dt} "
                f"from a start state: max_abs_err y {ey:.3g}, state {es:.3g}")
            if not ok:
                raise AssertionError(f"ssd_scan with init_state ({b},{S},"
                                     f"{nh},{hd},{N},{Q}) {dt}: kernel "
                                     f"disagrees (y {ey}, state {es})")
    args = _ssd_inputs(gen, 3, 128, 4, 64, 128, bf16, True)
    s0 = torch.randn(3, 4, 64, 128, generator=gen, device="cuda")
    dense = ops.ssd(*args, init_state=s0)
    masked = ops.ssd(*args, init_state=s0,
                     active=torch.tensor((0, 1, 0), device="cuda"))
    for d, m in zip(dense, masked):
        _check_lanes(m, d, (0, 1, 0), "ssd_scan with init_state")
    log("[kernel] ssd_scan masked bf16 from a start state: lanes 0 and 2 "
        "exact zeros, lane 1 bit-identical")

    # the model's layout: x, B, C are views of one (b, S, d_in + 2N) tensor
    b, S, nh, hd, N, Q = SSD_SERVE
    x, dt, A, B, C = _ssd_inputs(gen, b, S, nh, hd, N, bf16, True)
    xBC = torch.cat([x.reshape(b, S, nh * hd), B, C], dim=-1)
    views = (xBC[..., :nh * hd].reshape(b, S, nh, hd), dt, A,
             xBC[..., nh * hd:nh * hd + N], xBC[..., nh * hd + N:])
    got, want = sd.ssd_scan_cuda(*views), sd.ssd_scan_cuda(x, dt, A, B, C)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    log(f"[kernel] ssd_scan strided views of xBC (row stride "
        f"{views[0].stride(1)}): equal to contiguous inputs bit for bit "
        f"{same}")
    if not same:
        raise AssertionError("ssd_scan: strided views differ")
    # rows one element off a 16-byte boundary: the C entry reads them one
    # element at a time and reports it; the same tiles, so the same bits
    flat = torch.empty(xBC.numel() + 1, dtype=bf16, device="cuda")
    flat[1:] = xBC.reshape(-1)
    xBC1 = flat[1:].view(xBC.shape)
    odd = (xBC1[..., :nh * hd].reshape(b, S, nh, hd), dt, A,
           xBC1[..., nh * hd:nh * hd + N], xBC1[..., nh * hd + N:])
    before = sd.ssd_scan_cuda.scalar_reads
    got = sd.ssd_scan_cuda(*odd)
    scalar = sd.ssd_scan_cuda.scalar_reads - before
    same = all(torch.equal(g, w) for g, w in zip(got, sd.ssd_scan_cuda(
        *(t.contiguous() for t in odd))))
    log(f"[kernel] ssd_scan rows off a 16-byte boundary: {scalar} call with "
        f"scalar row reads, equal to contiguous inputs bit for bit {same}")
    if scalar != 1 or not same:
        raise AssertionError(f"ssd_scan: misaligned rows read the scalar "
                             f"path {scalar} times, bits equal {same}")

    # lane mask: y and the state zero on inactive lanes, exact on active
    args = _ssd_inputs(gen, 4, 256, 8, 64, 128, bf16, True)
    dense = ops.ssd(*args)
    for active in ((1, 0, 1, 0), (0, 0, 0, 1), (1, 1, 1, 1)):
        masked = ops.ssd(*args, active=torch.tensor(active, device="cuda"))
        for d, m in zip(dense, masked):
            _check_lanes(m, d, active, "ssd_scan")
    log("[kernel] ssd_scan masked bf16: y and state of inactive lanes exact "
        "zeros, active lanes bit-identical, for (1,0,1,0) (0,0,0,1) "
        "(1,1,1,1)")

    args = _ssd_inputs(gen, b, S, nh, hd, N, bf16, True)
    ms = cuda_time_ms(lambda: sd.ssd_scan_cuda(*args))
    dev_ms = device_ms(lambda: sd.ssd_scan_cuda(*args))
    plain_ms = cuda_time_ms(lambda: sd.ssd_scan_plain(*args), iters=5)
    b_ms, b_by = ssd_bound_ms(b, S, nh, hd, N, Q, 2)
    tc_ms, tc_by = ssd_tensor_core_bound_ms(b, S, nh, hd, N, Q, 2)
    by_kernel, per_call = kernel_profile(lambda: sd.ssd_scan_cuda(*args), 10)
    log(f"[kernel] ssd_scan {SSD_SERVE[:4]} N={N} chunk={Q} bf16: kernel "
        f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms, no "
        f"library call (no single PyTorch call computes SSD), bound "
        f"{b_ms:.4f} ms ({b_by}, f32 rate), on the tensor cores "
        f"{tc_ms:.4f} ms ({tc_by}, three bf16 products per f32 product)")
    kernels_per_call = sum(per_call.values())
    log(f"[kernel] ssd_scan CUDA kernels per call in the trace: "
        f"{kernels_per_call:g} {per_call}, device us each: {by_kernel}")
    if set(per_call.values()) != {1}:
        raise AssertionError(f"ssd_scan: each call should launch each of "
                             f"its kernels once, the trace has {per_call}")
    # four sequences at once: 768 CTAs a kernel instead of 192, so the
    # time shows whether one call is set by a wave's latency or by the
    # SMs' throughput
    args4 = _ssd_inputs(gen, 4 * b, S, nh, hd, N, bf16, True)
    dev4_ms = device_ms(lambda: sd.ssd_scan_cuda(*args4))
    log(f"[kernel] ssd_scan ({4 * b}, {S}, {nh}, {hd}) N={N} chunk={Q} "
        f"bf16: device {dev4_ms:.4f} ms, {dev4_ms / dev_ms:.2f}x the time "
        f"of one sequence for 4x the work")
    zamba2 = check_ssd_hybrid_shape(sd, gen, errs)
    args32 = _ssd_inputs(gen, b, S, nh, hd, N, f32, True)
    log(f"[kernel] ssd_scan {SSD_SERVE[:4]} N={N} chunk={Q} f32 (operands "
        f"split in three bf16 pieces): device "
        f"{device_ms(lambda: sd.ssd_scan_cuda(*args32)):.4f} ms")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:73",
            "launches": None, "body": "bf16",
            "kernels_per_call": kernels_per_call,
            "device_us_by_kernel": by_kernel,
            "tensor_core_bound_ms": tc_ms, "plan": plan,
            "device_ms_4_sequences": dev4_ms, "zamba2": zamba2,
            "max_abs_err": errs[SSD_SERVE + ("torch.bfloat16",)], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "library_device_ms": None}


def check_ssd_hybrid_shape(sd, gen, errs: dict) -> dict:
    """B4 at a zamba2-7b prefill's shape (112 heads of 64, N = 64), bf16:
    its plan, and its times beside the plain version and the bound (its
    agreement is held in ``check_ssd_scan``'s cases)."""
    import torch
    b, S, nh, hd, N, Q = SSD_HYBRID
    pl = sd.plan(b, S, nh, hd, N, Q, torch.bfloat16,
                 torch.cuda.current_device())
    args = _ssd_inputs(gen, b, S, nh, hd, N, torch.bfloat16, True)
    fn = lambda: sd.ssd_scan_cuda(*args)
    t = {"max_abs_err": errs[SSD_HYBRID + ("torch.bfloat16",)],
         "ms": cuda_time_ms(fn), "device_ms": device_ms(fn),
         "plain_ms": cuda_time_ms(lambda: sd.ssd_scan_plain(*args), iters=5),
         "ctas_per_sm": pl.ctas_per_sm, "smem": pl.smem}
    t["bound_ms"], t["bound_by"] = ssd_bound_ms(b, S, nh, hd, N, Q, 2)
    t["tensor_core_bound_ms"], _ = ssd_tensor_core_bound_ms(b, S, nh, hd, N,
                                                           Q, 2)
    log(f"[kernel] ssd_scan {SSD_HYBRID[:4]} N={N} chunk={Q} bf16 "
        f"(zamba2-7b): {b * (S // Q) * nh} CTAs per kernel, shared memory "
        f"{pl.smem} bytes, CTAs per SM {pl.ctas_per_sm}; kernel "
        f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}), plain "
        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}, f32 rate), on the tensor cores "
        f"{t['tensor_core_bound_ms']:.4f} ms")
    return t


def kernel_name(event) -> str:
    """A device event's kernel name without return type, namespace and
    template or parameter lists."""
    name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", event.name)
    return re.split(r"[<(]", name)[0]


def kernel_profile(fn, iters: int) -> tuple:
    """Per call of ``fn``, from a torch.profiler trace of ``iters`` calls:
    the device microseconds of each CUDA kernel it launches and how many
    times it launches each, by the kernel's short name."""
    fn()
    us: dict = {}
    n: dict = {}
    for e in device_events(fn, iters):
        name = kernel_name(e)
        us[name] = us.get(name, 0.0) + e.time_range.elapsed_us() / iters
        n[name] = n.get(name, 0) + 1 / iters
    return ({k: round(v, 2) for k, v in us.items()},
            {k: round(v, 3) for k, v in n.items()})


def check_mamba2_gradient() -> None:
    """A Mamba2 block's gradient on the card with the default impl: autograd
    needs the scan's result, so the block takes the chunked scan (B4 has no
    backward and is not launched), and the gradients of x and of every
    parameter agree with the CPU's within GRAD_TOL; the same block without
    grad launches B4 once."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ssd_scan as sd
    from repro_torch.models import ssm
    cfg = configs.get("mamba2-130m").reduced()
    params = ssm.init_mamba2(torch.Generator().manual_seed(3), cfg.d_model,
                             cfg.ssm, torch.float32)
    rng = np.random.default_rng(5)
    S = 2 * cfg.ssm.chunk_size
    x = torch.from_numpy((rng.standard_normal((2, S, cfg.d_model)) * 0.5)
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, S, cfg.d_model))
                         .astype(np.float32))

    def loss(params, x, w):
        y, state = ssm.mamba2_block(params, x, cfg.d_model, cfg.ssm)
        return (y * y * w).sum() + state.square().sum()

    grads = {}
    for dev in ("cpu", "cuda"):
        before = sd.ssd_scan_cuda.launches
        grads[dev] = torch.func.grad(loss, argnums=(0, 1))(
            _tree_to(params, dev), x.to(dev), w.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            if sd.ssd_scan_cuda.launches != before:
                raise AssertionError("mamba2 gradient launched B4")
    pairs = [(grads["cuda"][1], grads["cpu"][1])] + [
        (grads["cuda"][0][k], grads["cpu"][0][k]) for k in grads["cpu"][0]]
    err = max((a.cpu() - b).abs().max().item() for a, b in pairs)
    ok = all(torch.allclose(a.cpu(), b, **GRAD_TOL) for a, b in pairs)
    before = sd.ssd_scan_cuda.launches
    with torch.no_grad():
        ssm.mamba2_block(_tree_to(params, "cuda"), x.cuda(), cfg.d_model,
                         cfg.ssm)
    torch.cuda.synchronize()
    served = sd.ssd_scan_cuda.launches - before
    log(f"[kernel] mamba2 block gradient on the card ({cfg.name}, x "
        f"{tuple(x.shape)}, chunked scan under grad, no B4 launch) vs the "
        f"CPU: max_abs_err {err:.3g} over x and {len(pairs) - 1} parameters "
        f"({GRAD_TOL}); without grad the block launched B4 {served} time(s)")
    if not ok or served != 1:
        raise AssertionError(f"mamba2 gradient on the card: err {err}, B4 "
                             f"launches without grad {served}")


# ---------------------------------------------------------------------------
# phases 3-4: serving
# ---------------------------------------------------------------------------

def make_requests(seed: int, n: int, prompt_range, new_range, vocab: int):
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_range[0], prompt_range[1] + 1, n)
    news = rng.integers(new_range[0], new_range[1] + 1, n)
    return [Request(id=i, prompt=rng.integers(0, vocab, int(s)).astype(
        np.int64), max_new=int(m)) for i, (s, m) in enumerate(zip(lens, news))]


def pad_longest(reqs, length: int, vocab: int, seed: int = 1):
    """Extend the longest prompt of ``reqs`` to ``length`` tokens (drawn
    from numpy ``seed``), so the padded length is ``length``: an SSD
    prefill needs a multiple of its chunk."""
    longest = max(reqs, key=lambda r: len(r.prompt))
    extra = np.random.default_rng(seed).integers(
        0, vocab, length - len(longest.prompt)).astype(np.int64)
    longest.prompt = np.concatenate([longest.prompt, extra])
    return reqs


def mrope_streams(segments) -> tuple:
    """Qwen2-VL's (t, h, w) M-RoPE position streams over ``segments``, each
    ("text", n) or ("image", (rows, cols)) of merged patches: a text token
    takes t = h = w = the next position; an image starting at position p
    takes t = p, h = p + row, w = p + col; what follows resumes at the
    largest position so far + 1. Returns ((3, S) int64, that next position,
    which decode gives all three streams and then increments)."""
    cols, nxt = [], 0
    for kind, size in segments:
        if kind == "text":
            step = np.arange(nxt, nxt + size)
            cols.append(np.stack([step] * 3))
            nxt += size
        else:
            rows, width = size
            r, c = np.meshgrid(np.arange(rows), np.arange(width),
                               indexing="ij")
            cols.append(np.stack([np.full(rows * width, nxt),
                                  nxt + r.reshape(-1), nxt + c.reshape(-1)]))
            nxt += max(rows, width)
    return np.concatenate(cols, axis=1).astype(np.int64), nxt


def blocks_of(cfg) -> tuple:
    """(attention blocks, Mamba2 blocks) one forward of ``cfg`` runs (an
    encdec's encoder and decoder blocks both)."""
    if cfg.family == "encdec":
        return cfg.num_layers + cfg.num_encoder_layers, 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_period, cfg.num_layers
    if cfg.family == "ssm":
        return 0, cfg.num_layers
    return cfg.num_layers, 0


def check_small_reference() -> None:
    """Narrow f32 models served on the card through the kernels and on the
    CPU through the chunked paths, from the same parameters: prefill logits
    agree and tokens match. Configs: the reduced StableLM-2 at head dim 64
    and the stock reduced config (head dim 16, as every ``reduced()``
    config), the reduced DeepSeekMoE (routed experts) and the reduced
    Zamba2 with a tail (5 layers: two superblocks and one Mamba2 block),
    all through B3's f32 (simt) body, the hybrid through B4's f32 body
    too."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sd
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models.model import Model
    reduced = configs.get("stablelm-1.6b").reduced()
    hybrid = dataclasses.replace(configs.get("zamba2-7b").reduced(),
                                 num_layers=5)
    variants = (("head_dim 64", dataclasses.replace(
        reduced, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64)),
        ("stock reduced, head_dim 16", reduced),
        ("moe", configs.get("deepseek-moe-16b").reduced()),
        ("hybrid with a tail", hybrid))
    for label, cfg in variants:
        cpu_model = Model(cfg, device="cpu")
        cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
        gpu_model = Model(cfg, device="cuda")
        gpu_params = _tree_to(cpu_params, "cuda")
        chunk = cfg.ssm.chunk_size if cfg.ssm else 1
        S = -(-150 // chunk) * chunk
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, S)))
        before = (fa.flash_attention_cuda.launches_by_body["simt"],
                  sd.ssd_scan_cuda.launches_by_body["f32_split3"])
        lc, _ = cpu_model.prefill(cpu_params, {"tokens": toks}, max_len=192)
        lg, _ = gpu_model.prefill(gpu_params, {"tokens": toks.cuda()},
                                  max_len=192)
        launched = (fa.flash_attention_cuda.launches_by_body["simt"]
                    - before[0],
                    sd.ssd_scan_cuda.launches_by_body["f32_split3"]
                    - before[1])
        err = (lg.cpu() - lc).abs().max().item()
        log(f"[small] {label}: f32 prefill logits card (kernels; B3 simt "
            f"{launched[0]}, B4 f32 {launched[1]} launches) vs cpu "
            f"(chunked): max_abs_err {err:.3g} (atol {SMALL_LOGIT_ATOL_F32})")
        if not err <= SMALL_LOGIT_ATOL_F32 or launched != blocks_of(cfg):
            raise AssertionError(f"small reference {label}: logits differ "
                                 f"by {err}, launches {launched}, want "
                                 f"{blocks_of(cfg)}")
        outs = []
        for model, params in ((cpu_model, cpu_params),
                              (gpu_model, gpu_params)):
            reqs = make_requests(2, 5, (40, 120), (2, 9), cfg.vocab_size)
            if cfg.ssm:
                reqs = pad_longest(reqs, 128, cfg.vocab_size)
            outs.append(BatchServer(model, params, batch_lanes=2,
                                    max_len=160).run(reqs))
        if outs[0] != outs[1]:
            raise AssertionError(f"small reference {label}: card and cpu "
                                 f"tokens differ")
        log(f"[small] {label}: served 5 requests: card tokens == cpu tokens")


def ssm_requests(vocab: int):
    """8 requests from numpy seed 0: prompts 512-1024 tokens, the longest
    exactly 1024 (S_pad = 8 SSD chunks of 128), max_new 12-32."""
    return pad_longest(make_requests(0, 8, (512, 1024), (12, 32), vocab),
                       1024, vocab)


@contextlib.contextmanager
def dispatch_spy():
    """Within the block, every routed MoE dispatch appends (its top-k
    expert indices (T, k) sorted, the number of (token, expert) assignments
    its capacity dropped as a 0-dim tensor) to the yielded list; nothing is
    read back from the card. A slot is a rank among the assignments to one
    expert of one group, so an expert of a group drops what it gets past
    ``capacity``."""
    import torch
    from repro_torch.models import moe
    seen: list = []
    orig = moe._dispatch_compute_combine

    def spy(x, w, idx, params, m, e_start, e_local, capacity, groups=1):
        n = idx.numel()
        cat = (torch.arange(n, device=idx.device) // (n // groups) * e_local
               + idx.reshape(-1) - e_start)
        counts = torch.zeros(groups * e_local, dtype=torch.long,
                             device=idx.device).scatter_add_(
            0, cat, torch.ones_like(cat))
        seen.append((idx.sort(dim=-1).values,
                     (counts - capacity).clamp_min(0).sum()))
        return orig(x, w, idx, params, m, e_start, e_local, capacity, groups)
    moe._dispatch_compute_combine = spy
    try:
        yield seen
    finally:
        moe._dispatch_compute_combine = orig


def _ssd_exact(x, dt, A, B, C, *, chunk: int, init_state=None):
    """B4's plain version evaluated in f64: (y, final state)."""
    import torch
    from repro_torch.models import ssm
    f32, ssm._F32 = ssm._F32, torch.float64
    try:
        return ssm.ssd_chunked(
            x.double(), dt.double(), A.double(), B.double(), C.double(),
            chunk=chunk,
            init_state=None if init_state is None else init_state.double())
    finally:
        ssm._F32 = f32


@contextlib.contextmanager
def served_kernel_checks(tag: str):
    """Within the block, every bf16 B3 and B4 call of the model (``ops``)
    is held against its plain version on the same inputs, at [kernel]'s
    limits. B3: ``BF16_MAX_ABS``, which is stated for values of unit scale
    (|v| < 4), scaled by max |v| / 4 where the served values are wider.
    B4 takes the scale of its sums from the same function of |x|, |B| and
    |C| (dt > 0 and A < 0, so every decay is positive and these are the
    sums of the terms' magnitudes; a served prefill's y cancels, so its
    largest entry understates that scale): y within ``SSD_SCALED`` of it
    and one bf16 ulp of the plain y; the final state (f32) within
    ``SSD_SCALED`` of it of the plain version evaluated in f64, beyond the
    f32 plain version's own distance from that (two f32 evaluations of a
    served prefill's state part by more than their allowance: each lies
    near it from the f64 one). Yields a dict of the readings;
    raises at the first call that disagrees."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as sd
    seen = {"b3": [], "b3_limit": [], "b3_causal": [], "b4": [],
            "b4_state": [], "b4_own": []}
    attend, scan = ops.flash_attention, ops.ssd

    def attend_checked(q, k, v, causal=True, window=0, *, active=None):
        out = attend(q, k, v, causal=causal, window=window, active=active)
        ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        limit = BF16_MAX_ABS * max(1.0, v.float().abs().max().item() / 4)
        seen["b3"].append(err)
        seen["b3_limit"].append(limit)
        seen["b3_causal"].append(bool(causal))
        if not (err <= limit and torch.isfinite(out).all()):
            raise AssertionError(f"{tag}: B3 call {len(seen['b3'])} "
                                 f"{tuple(q.shape)} on served inputs: max "
                                 f"abs err {err} > {limit}")
        return out

    def scan_checked(x, dt, A, B, C, *, chunk=128, active=None,
                     init_state=None):
        out = scan(x, dt, A, B, C, chunk=chunk, active=active,
                   init_state=init_state)
        kw = dict(chunk=chunk, init_state=init_state)
        y, state = sd.ssd_scan_plain(x, dt, A, B, C, **kw)
        mag = sd.ssd_scan_plain(
            x.abs(), dt, A, B.abs(), C.abs(), chunk=chunk,
            init_state=None if init_state is None else init_state.abs())
        scale = [SSD_SCALED * max(1.0, m.float().max().item()) for m in mag]
        err_y = (out[0].float() - y.float()).abs()
        ok = bool((err_y <= scale[0] + BF16_ULP_REL * y.float().abs()).all())
        exact = _ssd_exact(x, dt, A, B, C, **kw)[1]
        err_state = (out[1].double() - exact).abs().max().item()
        own = (state.double() - exact).abs().max().item()
        ok = ok and err_state <= own + scale[1] \
            and bool(torch.isfinite(out[0]).all())
        seen["b4"].append(err_y.max().item())
        seen["b4_state"].append(err_state / (own + scale[1]))
        seen["b4_own"].append(own / scale[1])
        if not ok:
            raise AssertionError(f"{tag}: B4 call {len(seen['b4'])} "
                                 f"{tuple(x.shape)} on served inputs: max "
                                 f"abs err y {seen['b4'][-1]}, final state "
                                 f"from f64 {err_state} (the f32 plain "
                                 f"version's {own}, scale {scale[1]})")
        return out
    ops.flash_attention, ops.ssd = attend_checked, scan_checked
    try:
        yield seen
    finally:
        ops.flash_attention, ops.ssd = attend, scan


def serve_family(tag: str, cfg, reqs_fn, b3: dict, b4: dict, *,
                 main: bool = False, atol: float = LOGIT_ATOL_BF16,
                 trace: bool = False):
    """``BatchServer(batch_lanes=4, max_len=2048)`` serving ``reqs_fn()`` on
    a full-width ``cfg`` (random f32 weights from torch seed 0, bf16
    compute), every count set to 0 just before the run and read just after
    it. Gates: lane steps == Σ max_new; B3 launches == prefills × attention
    blocks, all on the wgmma body; B4 calls == prefills × Mamba2 blocks, all
    bf16 with no scalar row reads; every token in the vocabulary. Logs
    prefill ms per request, decode tokens/s and ms per step, peak memory,
    and for a moe model the (token, expert) assignments each prefill's
    capacity dropped. ``trace`` serves the requests once more under
    torch.profiler and holds B4's CUDA kernels in the trace to one each a
    call. Then ``compare_routes`` on the longest prompt (unpadded in the
    server, request 0 of every path here), within ``atol``, and the same
    requests with adaptive lanes: the same first tokens. The launches go
    into the B3 and B4 records under "launches" for a ``main`` path, else
    "launches_<tag>". Returns (model, params, the compared prompt)."""
    import gc

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sd
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models.model import Model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_attn, n_ssm = blocks_of(cfg)
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers ({n_attn} attention "
        f"blocks, {n_ssm} Mamba2 blocks), d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params f32 ({4 * n_params / 1e9:.1f} GB), "
        f"init {time.perf_counter() - t0:.1f} s")

    reqs = reqs_fn()
    total_new = sum(r.max_new for r in reqs)
    srv = BatchServer(model, params, batch_lanes=4, max_len=2048)
    per_prefill: list = []             # dispatches seen after each prefill
    prefill = model.prefill

    def counted(*a, **kw):
        out = prefill(*a, **kw)
        per_prefill.append(len(dispatched))
        return out
    model.prefill = counted
    torch.cuda.reset_peak_memory_stats()
    with dispatch_spy() as dispatched:
        reset_launches()
        t0 = time.perf_counter()
        out = srv.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    del model.prefill
    by_body = dict(fa.flash_attention_cuda.launches_by_body)
    b4_by_body = dict(sd.ssd_scan_cuda.launches_by_body)
    scalar = sd.ssd_scan_cuda.scalar_reads
    name = "launches" if main else f"launches_{tag.replace('-', '_')}"
    if n_attn:
        b3[name], b3[f"{name}_by_body"] = launches["flash_attention_fwd"], \
            by_body
    if n_ssm:
        b4[name], b4[f"{name}_by_body"] = launches["ssd_scan"], b4_by_body
        b4[name.replace("launches", "scalar_reads")] = scalar
    st = srv.stats
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_tokens = st.lane_steps - st.prefills
    s_pad = max(len(r.prompt) for r in reqs)
    log(f"[{tag}] 8 requests, prompts {min(len(r.prompt) for r in reqs)}-"
        f"{s_pad} tokens, max_new {min(r.max_new for r in reqs)}-"
        f"{max(r.max_new for r in reqs)}: wall {wall:.3f} s, prefills "
        f"{st.prefills}, global_steps {st.global_steps}, lane_steps "
        f"{st.lane_steps}, lane_slots {st.lane_slots}, launches {launches}; "
        f"flash_attention by body {by_body}, ssd_scan by body {b4_by_body}, "
        f"scalar row reads {scalar}")
    log(f"[{tag}] prefill {1e3 * st.prefill_s / st.prefills:.2f} ms/request "
        f"(S_pad {s_pad}), decode {decode_tokens / st.decode_s:.1f} "
        f"tokens/s over {st.global_steps} steps "
        f"({1e3 * st.decode_s / st.global_steps:.2f} ms/step), peak memory "
        f"{peak_gb:.2f} GB")
    if cfg.moe:
        # a prefill dispatches once a layer, just before its entry
        drops = [int(sum(d for _, d in dispatched[e - cfg.num_layers:e]))
                 for e in per_prefill]
        log(f"[{tag}] (token, expert) assignments dropped by capacity in "
            f"each prefill (of S_pad x top-{cfg.moe.top_k} x "
            f"{cfg.num_layers} layers = "
            f"{s_pad * cfg.moe.top_k * cfg.num_layers}): {drops}; by the "
            f"decode steps {int(sum(d for _, d in dispatched)) - sum(drops)}")
    if st.lane_steps != total_new:
        raise AssertionError(f"{tag}: lane_steps {st.lane_steps} != Σ "
                             f"max_new {total_new}")
    b3_n, b4_n = launches["flash_attention_fwd"], launches["ssd_scan"]
    if b3_n != st.prefills * n_attn or by_body["wgmma"] != b3_n:
        raise AssertionError(f"{tag}: flash_attention launches {b3_n} (by "
                             f"body {by_body}) != prefills {st.prefills} x "
                             f"{n_attn}, all wgmma")
    if b4_n != st.prefills * n_ssm or b4_by_body["bf16"] != b4_n or scalar:
        raise AssertionError(f"{tag}: ssd_scan calls {b4_n} (by body "
                             f"{b4_by_body}, {scalar} with scalar row "
                             f"reads) != prefills {st.prefills} x {n_ssm}, "
                             f"all bf16")
    if b3_n + b4_n == 0:
        raise AssertionError(f"{tag}: no kernel launched")
    for r in reqs:
        toks = out[r.id]
        if len(toks) != r.max_new or not all(0 <= t < cfg.padded_vocab
                                             for t in toks):
            raise AssertionError(f"{tag} request {r.id}: bad tokens {toks}")
    if trace:
        trace_ssd(tag, model, params, reqs_fn, b4, b4_n)

    r0 = max(reqs, key=lambda r: len(r.prompt))
    compare_routes(tag, cfg, params, r0, out[r0.id][0], b3, atol)

    # the same requests with adaptive lanes
    reqs2 = reqs_fn()
    srv2 = BatchServer(model, params, batch_lanes=4, max_len=2048,
                       adaptive_lanes=True)
    out2 = srv2.run(reqs2)
    agree = sum(a == b for r in reqs for a, b in zip(out[r.id], out2[r.id]))
    firsts = all(out[r.id][0] == out2[r.id][0] for r in reqs)
    log(f"[{tag}] adaptive_lanes: resizes {srv2.stats.resizes}, lane_slots "
        f"{srv2.stats.lane_slots} vs {st.lane_slots}; tokens agreeing with "
        f"the fixed pool {agree}/{total_new} ({agree / total_new:.3f}); "
        f"first tokens equal {firsts}")
    if srv2.stats.lane_steps != total_new or not firsts:
        raise AssertionError(f"{tag} adaptive run: lane_steps or first "
                             f"tokens off")
    return model, params, r0.prompt


def trace_ssd(tag: str, model, params, reqs_fn, b4: dict, calls: int):
    """The requests served again under torch.profiler, every count set to 0
    just before: B4's CUDA kernels counted in the trace, each once a call
    (``calls``, the untraced run's)."""
    from repro_torch.launch.serve import BatchServer
    traced = {}

    def run_traced():
        fresh = reqs_fn()                  # the server fills r.out
        reset_launches()
        BatchServer(model, params, batch_lanes=4, max_len=2048).run(fresh)
        traced.update(read_launches())

    by_name: dict = {}
    for e in device_events(run_traced):
        name = kernel_name(e)
        if name.startswith("ssd_"):
            by_name[name] = by_name.get(name, 0) + 1
    b4["kernels"] = sum(by_name.values())
    b4["kernels_by_name"] = by_name
    log(f"[{tag}] traced run: {traced['ssd_scan']} ssd_scan calls, CUDA "
        f"kernels in the trace {b4['kernels']} {by_name}")
    if traced["ssd_scan"] != calls or not by_name \
            or set(by_name.values()) != {calls}:
        raise AssertionError(f"ssd_scan: the traced run made "
                             f"{traced['ssd_scan']} calls (untraced {calls}) "
                             f"and launched {by_name}")


def compare_routes(tag: str, cfg, params, r0, served_first: int, b3: dict,
                   atol: float, batch: dict = None,
                   twins: bool = False) -> None:
    """``r0``'s prefill logits (of ``batch``, by default its prompt's
    tokens) through the kernels against their plain
    versions, within ``atol``, every B3 and B4 call of the kernel route held
    against its plain version on its served inputs
    (``served_kernel_checks``), and the kernel route's token equal to the
    served first token; where the plain route's top-2 gap exceeds 2 ·
    ``atol``, the two routes' tokens are equal too. For a moe model it logs
    the (layer, token) top-k sets that differ between the routes; for a
    model with Mamba2 blocks it logs the bf16 plain route's distance from
    its rounding twins (SSD chunk 64, f32) and holds the two routes in f32
    (B3's simt and B4's f32 bodies) to ``DEEP_LOGIT_ATOL_F32``; ``twins``
    does the f32 part for a model without them."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ParallelCtx
    key = tag.replace("-", "_")
    if batch is None:
        batch = {"tokens": torch.from_numpy(r0.prompt[None]).cuda()}
    S = batch["embeds" if "embeds" in batch else "tokens"].shape[1]
    frames = (f", Se {batch['enc_embeds'].shape[1]}" if "enc_embeds" in batch
              else "")
    route = lambda c, impl: Model(c, ParallelCtx(attn_impl=impl),
                                  device="cuda").prefill(
        params, batch, max_len=2048)[0]
    with torch.inference_mode(), dispatch_spy() as seen:
        with served_kernel_checks(tag) as calls:
            lk = route(cfg, "kernel")
        n_routes = len(seen)
        lp = route(cfg, "plain")
    b3_err = max(calls["b3"], default=0.0)
    log(f"[{tag}] request {r0.id}'s kernel-route prefill: "
        f"{len(calls['b3'])} B3 calls on served inputs, max abs err "
        f"{b3_err:.4g} (limit {min(calls['b3_limit'], default=0.0):.4g}"
        f"-{max(calls['b3_limit'], default=0.0):.4g}); "
        f"{len(calls['b4'])} B4 calls, max abs err y "
        f"{max(calls['b4'], default=0.0):.4g} (SSD_SCALED of the sums' "
        f"magnitudes and one bf16 ulp), final state from f64 at most "
        f"{max(calls['b4_state'], default=0.0):.3f} of its limit (the f32 "
        f"plain state's own distance up to "
        f"{max(calls['b4_own'], default=0.0):.3f} of SSD_SCALED's)")
    b3[f"{key}_served_calls_err"] = b3_err
    flips = sum(int((a != b).any(-1).sum())
                for (a, _), (b, _) in zip(seen[:n_routes], seen[n_routes:]))
    err = (lk - lp).abs().max().item()
    top2 = lp[0].topk(2).values
    gap = (top2[0] - top2[1]).item()
    kernel_first = int(lk.argmax())
    same = kernel_first == int(lp.argmax())
    routes = (f", top-k sets differing between the routes {flips} of "
              f"{n_routes * S} (layer, token)" if cfg.moe else "")
    log(f"[{tag}] request {r0.id} (S {S}{frames}) prefill logits, "
        f"kernels vs plain: max_abs_err {err:.4g} (atol {atol}), logit std "
        f"{lp.std().item():.3f}, top-2 gap {gap:.4g}, argmax equal {same}, "
        f"kernel route's token == served first token "
        f"{kernel_first == served_first}{routes}")
    b3[f"{key}_logit_err"] = err
    if not (torch.isfinite(lk).all() and err <= atol
            and kernel_first == served_first and (same or gap <= 2 * atol)):
        raise AssertionError(f"{tag} prefill logits: kernels vs plain err "
                             f"{err} > {atol}, or the tokens differ "
                             f"(kernel {kernel_first}, plain "
                             f"{int(lp.argmax())}, served {served_first})")
    if blocks_of(cfg)[1] or twins:
        # the bf16 route's rounding twins: the plain route at SSD chunk 64
        # (the same function summed in another f32 order), and in f32
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        with torch.inference_mode():
            twin = "none (no SSD)"
            if cfg.ssm:
                chunk_64 = dataclasses.replace(
                    cfg, ssm=dataclasses.replace(cfg.ssm, chunk_size=64))
                twin = f"{(route(chunk_64, 'plain') - lp).abs().max():.4g}"
            lp32 = route(f32, "plain")
            err32 = (route(f32, "kernel") - lp32).abs().max().item()
        twin32 = (lp - lp32).abs().max().item()
        log(f"[{tag}] request {r0.id} prefill logits in f32 (B3 simt, B4 "
            f"f32 bodies), kernels vs plain: max_abs_err {err32:.4g} (atol "
            f"{DEEP_LOGIT_ATOL_F32}); bf16 rounding twins of the plain "
            f"route: at SSD chunk 64 {twin}, against f32 {twin32:.4g}")
        b3[f"{key}_logit_err_f32"] = err32
        b3[f"{key}_bf16_twin_f32"] = twin32
        if not err32 <= DEEP_LOGIT_ATOL_F32:
            raise AssertionError(f"{tag} f32 prefill logits: kernels vs "
                                 f"plain err {err32}")


# [serve-vlm]: Qwen2-VL-7B's requests, each a text prefix, one image of
# merged patches on one of these grids, and a text suffix
VLM_GRIDS = ((16, 16), (24, 24), (32, 24), (24, 32))
# [serve-encdec]: SeamlessM4T-medium's encoder frames per request, and the
# decoder caches' lengths, neither equal to any Se (the cross K/V cache
# must come back Se rows long whatever max_len is)
ENCDEC_FRAMES = (512, 768, 1024, 1024)
ENCDEC_MAX_LENS = (64, 2048, 64, 2048)


def vlm_requests(vocab: int, d_model: int, seed: int = 0) -> list:
    """4 requests from numpy ``seed``: text prefix and suffix of 16-64
    tokens around one image on ``VLM_GRIDS`` (its rows seeded N(0,1) x 0.1,
    the config's stub frontend), max_new 16-32, with their M-RoPE
    streams."""
    import types
    rng = np.random.default_rng(seed)
    reqs = []
    for i, grid in enumerate(VLM_GRIDS):
        n1, n2 = (int(n) for n in rng.integers(16, 65, 2))
        segs = (("text", n1), ("image", grid), ("text", n2))
        pos, nxt = mrope_streams(segs)
        reqs.append(types.SimpleNamespace(
            id=i, text=rng.integers(0, vocab, n1 + n2), n1=n1,
            image=(rng.standard_normal((grid[0] * grid[1], d_model))
                   * 0.1).astype(np.float32),
            mrope=pos, next_pos=nxt, S=pos.shape[1],
            max_new=int(rng.integers(16, 33)), max_len=2048))
    return reqs


def encdec_requests(vocab: int, d_model: int, seed: int = 0) -> list:
    """4 requests from numpy ``seed``: ``ENCDEC_FRAMES`` frames of seeded
    N(0,1) x 0.1 (the config's stub speech frontend), a decoder prompt of
    2-8 tokens, max_new 24-48, cache length ``ENCDEC_MAX_LENS``."""
    import types
    rng = np.random.default_rng(seed)
    return [types.SimpleNamespace(
        id=i, frames=(rng.standard_normal((se, d_model)) * 0.1).astype(
            np.float32),
        text=rng.integers(0, vocab, int(rng.integers(2, 9))),
        max_new=int(rng.integers(24, 49)), max_len=ml)
        for i, (se, ml) in enumerate(zip(ENCDEC_FRAMES, ENCDEC_MAX_LENS))]


def embeds_batch(model, params, r) -> dict:
    """The prefill batch of a [serve-vlm] or [serve-encdec] request on the
    model's device, in the compute dtype: the vlm's text rows are the embedding
    table's rows of its tokens, its image rows the request's."""
    import torch
    cdt, dev = model.cdt, model.device
    text = torch.from_numpy(r.text).to(dev)
    if model.cfg.family == "vlm":
        rows = params["embed"][text].to(cdt)
        img = torch.from_numpy(r.image).to(dev, cdt)
        embeds = torch.cat([rows[:r.n1], img, rows[r.n1:]])[None]
        return {"embeds": embeds,
                "mrope_pos": torch.from_numpy(r.mrope[:, None]).to(dev)}
    return {"enc_embeds": torch.from_numpy(r.frames[None]).to(dev, cdt),
            "tokens": text[None]}


def embeds_step(model, r, batch, tok, i: int) -> dict:
    """The batch of decode step ``i`` after request ``r``'s prefill
    ``batch``: token ``tok`` (1, 1) at position S + i and, for the vlm, all
    three M-RoPE streams at the request's next position + i."""
    import torch
    dev = model.device
    S = batch["tokens" if model.cfg.is_encdec else "embeds"].shape[1]
    step = {"tokens": tok.to(dev), "pos": torch.full((1,), S + i,
                                                     device=dev)}
    if model.cfg.family == "vlm":
        step["mrope_pos"] = torch.full((3, 1, 1), r.next_pos + i,
                                       device=dev)
    return step


@contextlib.contextmanager
def causal_spy():
    """Within the block, the ``causal`` flag of every ``ops.flash_attention``
    call is appended to the yielded list (the launch counts stay the
    wrappers')."""
    from repro_torch.kernels import ops
    seen: list = []
    attend = ops.flash_attention

    def spy(q, k, v, causal=True, window=0, *, active=None):
        seen.append(bool(causal))
        return attend(q, k, v, causal=causal, window=window, active=active)
    ops.flash_attention = spy
    try:
        yield seen
    finally:
        ops.flash_attention = attend


def serve_embeds(tag: str, cfg, reqs_fn, b3: dict,
                 atol: float = LOGIT_ATOL_BF16):
    """The model's own serving entry points on requests fed embeddings (the
    reference's server takes token batches only): each request's
    ``Model.prefill`` at batch 1, then greedy ``decode_step``s up to its
    max_new, on a full ``cfg`` (random f32 weights from torch seed 0, bf16
    compute), every count set to 0 just before the run and read just after
    it. Gates: B3 launches == prefills x attention blocks (an encdec's
    encoder half non-causal), all on the wgmma body, none in decode; every
    token in the vocabulary. Logs prefill ms per request, decode tokens/s,
    peak memory. Then ``compare_routes`` on the longest request (with its
    f32 twins), and a [profile] of one prefill and one decode step."""
    import gc

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_attn = blocks_of(cfg)[0]
    n_enc = cfg.num_encoder_layers if cfg.is_encdec else 0
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} decoder layers"
        f"{f' + {n_enc} encoder layers' if n_enc else ''}, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV heads "
        f"of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab}: {n_params / 1e9:.3f} B params f32 "
        f"({4 * n_params / 1e9:.1f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = reqs_fn()
    batches = [embeds_batch(model, params, r) for r in reqs]
    out, prefill_ms, decode_s, in_prefill = {}, [], 0.0, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), causal_spy() as causal:
        reset_launches()
        for r, batch in zip(reqs, batches):
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, batch, max_len=r.max_len)
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
            in_prefill = fa.flash_attention_cuda.launches
            if cfg.is_encdec and tuple(cache["cross_k"].shape[:3]) != (
                    cfg.num_layers, 1, r.frames.shape[0]):
                raise AssertionError(f"{tag} request {r.id}: cross K/V "
                                     f"cache {tuple(cache['cross_k'].shape)}"
                                     f", want Se = {r.frames.shape[0]} rows")
            toks = [tok]
            t0 = time.perf_counter()
            for i in range(r.max_new - 1):
                logits, cache = model.decode_step(
                    params, embeds_step(model, r, batch, tok[:, None], i),
                    cache)
                tok = logits.argmax(-1)
                toks.append(tok)
            out[r.id] = torch.cat(toks).tolist()
            decode_s += time.perf_counter() - t0
            if fa.flash_attention_cuda.launches != in_prefill:
                raise AssertionError(f"{tag} request {r.id}: B3 launched in "
                                     f"decode")
            del cache
        launches = read_launches()
    by_body = dict(fa.flash_attention_cuda.launches_by_body)
    name = f"launches_{tag.replace('-', '_')}"
    b3[name], b3[f"{name}_by_body"] = launches["flash_attention_fwd"], by_body
    b3[f"{name}_noncausal"] = causal.count(False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_dec = sum(r.max_new - 1 for r in reqs)
    lengths = [b["tokens" if cfg.is_encdec else "embeds"].shape[1]
               for b in batches]
    frames = [r.frames.shape[0] for r in reqs] if cfg.is_encdec else None
    log(f"[{tag}] {len(reqs)} requests, prefill lengths {lengths}"
        f"{f', encoder frames {frames}' if frames else ''}, max_new "
        f"{[r.max_new for r in reqs]}, max_len {[r.max_len for r in reqs]}:"
        f" launches {launches}; flash_attention by body {by_body}, "
        f"non-causal {causal.count(False)} of {len(causal)}")
    log(f"[{tag}] prefill ms per request "
        f"{[round(ms, 2) for ms in prefill_ms]}, decode "
        f"{n_dec / decode_s:.1f} tokens/s over {n_dec} steps at batch 1 "
        f"({1e3 * decode_s / n_dec:.2f} ms/step), peak memory "
        f"{peak_gb:.2f} GB")
    b3_n = launches["flash_attention_fwd"]
    if (b3_n != len(reqs) * n_attn or by_body["wgmma"] != b3_n
            or causal.count(False) != len(reqs) * n_enc):
        raise AssertionError(f"{tag}: flash_attention launches {b3_n} (by "
                             f"body {by_body}, non-causal "
                             f"{causal.count(False)}) != prefills "
                             f"{len(reqs)} x {n_attn}, all wgmma, "
                             f"{n_enc} a prefill non-causal")
    for r in reqs:
        toks = out[r.id]
        if len(toks) != r.max_new or not all(0 <= t < cfg.padded_vocab
                                             for t in toks):
            raise AssertionError(f"{tag} request {r.id}: bad tokens {toks}")
    i0 = int(np.argmax([S + (r.frames.shape[0] if cfg.is_encdec else 0)
                        for S, r in zip(lengths, reqs)]))
    compare_routes(tag, cfg, params, reqs[i0], out[reqs[i0].id][0], b3,
                   atol, batch=batches[i0], twins=True)
    profile_embeds(model, params, reqs[i0], batches[i0])


def profile_embeds(model, params, r, batch) -> None:
    """Device time by kernel and by kind, and the device's idle share, for
    one prefill of ``batch`` and one decode step after it (batch 1, as
    ``serve_embeds`` serves)."""
    import torch
    S = batch["tokens" if model.cfg.is_encdec else "embeds"].shape[1]
    with torch.inference_mode():
        _, cache = model.prefill(params, batch, max_len=r.max_len)
        step = embeds_step(model, r, batch, torch.zeros(
            (1, 1), dtype=torch.long), 0)
        name = model.cfg.name
        calls = ((f"{name} prefill (S {S})", lambda: model.prefill(
            params, batch, max_len=r.max_len)),
                 (f"{name} decode step", lambda: model.decode_step(
                     params, step, cache)))
        for _, by_name in profile_calls(calls):
            log_by_kind(by_name)


def serve_embeds_paths(b3: dict) -> None:
    """[serve-vlm] (Qwen2-VL-7B) and [serve-encdec] (SeamlessM4T-medium),
    each at its published width and depth, nothing cut."""
    from repro_torch import configs
    for tag, name, make in (("serve-vlm", "qwen2-vl-7b", vlm_requests),
                            ("serve-encdec", "seamless-m4t-medium",
                             encdec_requests)):
        cfg = configs.get(name)
        serve_embeds(tag, cfg, lambda c=cfg, m=make: m(c.vocab_size,
                                                        c.d_model), b3)


# [serve-moe]: DeepSeekMoE-16B at its published width, its depth cut from 28
# to 14 layers (8.65 B params, 34.6 GB in f32). All 28 (67.5 GB) fit on an
# NVIDIA H100 80GB HBM3 at 700 W (peak 70.93 GB serving), but there the
# kernel-vs-plain logit gate (LOGIT_ATOL_BF16) read 0.2607, with 8,207 of
# 26,544 (layer, token) top-k sets differing between the two routes
# (near-ties among 64 random-weight experts) while each B3 call of that
# prefill held [kernel]'s limit on its served inputs. The gate is kept as
# it was set for this path, at 14 layers, where it reads 0.2031
MOE_LAYERS = 14


def serve_paths(b3: dict, b4: dict) -> None:
    """Phase 4: [serve] (StableLM-2 1.6B, B3), [serve-ssm] (mamba2-130m,
    B4, traced), [serve-moe] (DeepSeekMoE-16B, B3) and [serve-hybrid]
    (Zamba2-7B, B3 and B4), each at its published width and depth but the
    moe's (``MOE_LAYERS``), each followed by its [profile]."""
    from repro_torch import configs
    published = configs.get("deepseek-moe-16b")
    moe = dataclasses.replace(published, num_layers=MOE_LAYERS)
    log(f"[serve-moe] depth cut from {published.num_layers} to "
        f"{MOE_LAYERS} layers; width as published: {moe.moe.num_experts} "
        f"routed experts of {moe.moe.expert_d_ff} + "
        f"{moe.moe.num_shared_experts} shared, top-{moe.moe.top_k}, "
        f"capacity factor {moe.moe.capacity_factor}")
    dense_reqs = lambda c: lambda: make_requests(0, 8, (512, 1024), (8, 32),
                                                 c.vocab_size)
    ssm_reqs = lambda c: lambda: ssm_requests(c.vocab_size)
    for tag, cfg, reqs, kw in (
            ("serve", configs.get("stablelm-1.6b"), dense_reqs,
             dict(main=True)),
            ("serve-ssm", configs.get("mamba2-130m"), ssm_reqs,
             dict(main=True, atol=SSM_LOGIT_ATOL_BF16, trace=True)),
            ("serve-moe", moe, dense_reqs, {}),
            ("serve-hybrid", configs.get("zamba2-7b"), ssm_reqs,
             dict(atol=HYBRID_LOGIT_ATOL_BF16))):
        profile_serving(*serve_family(tag, cfg, reqs(cfg), b3, b4, **kw))


def profile_calls(calls) -> list:
    """For each (label, fn): the host-clock wall time of a warm call (median
    of 3, unprofiled), the sum of kernel durations in a torch.profiler trace
    of one call, the device's idle share (1 - busy / wall, busy the union
    of the kernels' intervals: kernels on other streams may overlap, as
    cuDNN's do, and then their sum exceeds the wall), and the top kernels
    by device time. Returns (wall ms, {kernel: (ms, launches)}) per
    call."""
    import torch
    readings = []
    for label, fn in calls:
        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        wall_ms = float(np.median(walls[1:]))
        by_name: dict = {}
        spans = []
        for e in device_events(fn, with_cpu=True):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
            spans.append((e.time_range.start, e.time_range.end))
        kernel_ms = sum(ms for ms, _ in by_name.values())
        busy_ms, reach = 0.0, None
        for start, end in sorted(spans):
            if reach is not None and start < reach:
                start = reach
            if end > start:
                busy_ms += (end - start) / 1e3
            reach = end if reach is None else max(reach, end)
        launches = sum(n for _, n in by_name.values())
        log(f"[profile] {label}: wall {wall_ms:.2f} ms (median of 3, "
            f"{min(walls[1:]):.2f}-{max(walls[1:]):.2f}, unprofiled), "
            f"kernels {kernel_ms:.2f} ms in {launches} launches (busy "
            f"{busy_ms:.2f} ms), device idle {1 - busy_ms / wall_ms:.3f}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        for name, (ms, n) in top:
            log(f"[profile]   {ms:8.3f} ms {ms / kernel_ms:6.1%} x{n:<4d} "
                f"{name[:70]}")
        readings.append((wall_ms, by_name))
    return readings


def profile_serving(model, params, prompt: np.ndarray) -> None:
    """Device time by kernel and by kind, and the device's idle share, for
    one prefill of ``prompt`` and one 4-lane decode step of ``model`` as the
    server steps it (``profile_calls``); for a moe model also the share of
    its kernels that casts the f32 expert weights to bf16."""
    import torch
    from repro_torch.core import packing
    toks = torch.from_numpy(prompt[None]).cuda()
    axes = model.cache_lane_axes()
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": toks}, max_len=2048)
        lane = packing.tree_get_lane(cache, 0, axes)
        pool = packing.stack_trees([lane] * 4, axes)
        del cache, lane
        step = {"tokens": torch.zeros((4, 1), dtype=torch.long,
                                      device="cuda"),
                "pos": torch.full((4,), toks.shape[1], device="cuda")}
        name = model.cfg.name
        calls = (
            (f"{name} prefill", lambda: model.prefill(
                params, {"tokens": toks}, max_len=2048)),
            (f"{name} decode", lambda: model.decode_step(
                params, step, pool, route_rows=True)))
        busy = [log_by_kind(by_name) for _, by_name in profile_calls(calls)]
        if model.cfg.moe:
            experts = params["blocks"]["moe"]
            casts = lambda: [experts[w][0].to(torch.bfloat16)
                             for w in ("w_gate", "w_up", "w_down")]
            L = model.cfg.num_layers
            cast_ms = L * device_ms(casts, iters=3)
            log(f"[profile] {name}: f32 expert-weight casts to bf16 "
                f"{cast_ms:.2f} ms a forward ({L} layers); share of the "
                f"prefill's kernels {cast_ms / busy[0]:.3f}, of the decode "
                f"step's {cast_ms / busy[1]:.3f}")


# ---------------------------------------------------------------------------
# phases 5-6: training
# ---------------------------------------------------------------------------

def lenet_step(opt):
    """The paper's per-task step: one SGD step of LeNet-4 (one lane)."""
    import torch
    from repro_torch import optim
    from repro_torch.models import lenet

    def step(params, opt_state, batch, lr):
        g, loss = torch.func.grad_and_value(lenet.loss)(params, batch)
        upd, opt_state = opt.update(g, opt_state, params, lr)
        return optim.apply_updates(params, upd), opt_state, {"loss": loss}
    return step


def resnet_step(opt):
    """The paper's §III-B per-task step: one SGD step of ResNet-18 (one
    lane), as ``benchmarks/bench_imagenet_sharing.py``'s ``_step_fn``."""
    import torch
    from repro_torch import optim
    from repro_torch.models import resnet

    def step(params, opt_state, batch, lr):
        g, loss = torch.func.grad_and_value(resnet.loss)(params, batch)
        upd, opt_state = opt.update(g, opt_state, params, lr)
        return optim.apply_updates(params, upd), opt_state, {"loss": loss}
    return step


def _run_refill(pool, tasks, **kw):
    """Per-task losses, stats and the executor of one RefillExecutor run."""
    from repro_torch.core.lanepool import RefillExecutor
    losses: dict = {}

    def on_metrics(t, s, m):
        losses.setdefault(t.id, []).append(float(m["loss"]))
        return False
    ex = RefillExecutor(pool, on_metrics=on_metrics, **kw)
    t0 = time.perf_counter()
    stats = ex.run(tasks)
    return losses, stats, ex, time.perf_counter() - t0


def _compare_losses(label: str, got: dict, want: dict, tol: dict = LOSS_TOL,
                    phase: str = "train-lenet") -> float:
    """Per-task losses allclose at ``tol``; logs the bit-equal count and
    returns the largest gap."""
    if sorted(got) != sorted(want) or any(
            len(got[t]) != len(want[t]) for t in want):
        raise AssertionError(f"{label}: tasks or step counts differ")
    flat_g = np.concatenate([np.float32(got[t]) for t in sorted(want)])
    flat_w = np.concatenate([np.float32(want[t]) for t in sorted(want)])
    equal = int((flat_g == flat_w).sum())
    diff = float(np.abs(flat_g - flat_w).max())
    log(f"[{phase}] {label}: {equal}/{flat_w.size} per-task losses "
        f"bit-equal, max diff {diff:.3g} (allclose "
        f"{', '.join(f'{k}={v}' for k, v in tol.items())})")
    if not (np.isfinite(flat_g).all()
            and np.allclose(flat_g, flat_w, **tol)):
        raise AssertionError(f"{label}: per-task losses differ by {diff}")
    return diff


def train_lenet() -> tuple:
    """The paper's workflow on the card (examples/quickstart.py and
    benchmarks/bench_mnist_sharing.py of the reference) at its batch of 64.
    Returns a full 8-lane "where" pool and its batch, for the profile."""
    import tempfile

    import torch
    from repro_torch import optim
    from repro_torch.core import packing
    from repro_torch.core.lanepool import LanePool, LaneTask, PoolSnapshot
    from repro_torch.core.lanepool import rehydrate
    from repro_torch.core.monitor import profile_fn
    from repro_torch.core.triples import NodeSpec, Triples, plan
    from repro_torch.data.mnist import synthetic_mnist
    from repro_torch.models import lenet
    dev = "cuda"
    node = NodeSpec(chips_per_node=1, hbm_per_chip=80e9)
    trip = Triples(nnode=1, nppn=8, ntpp=1)
    p = plan(8, trip, node)
    log(f"[train-lenet] plan(8, {trip}, 1 chip of 80 GB): pack factor "
        f"{p.pack_factor} tasks/chip, sharing {trip.is_sharing(node)}, "
        f"chip load {p.chip_load()}")
    if p.pack_factor != 8 or p.chip_load() != {(0, 0): 8}:
        raise AssertionError("triples plan: 8 tasks should share the chip")

    opt = optim.sgd()
    step = lenet_step(opt)
    init = lambda seed: lenet.init(torch.Generator(device=dev).manual_seed(
        seed))

    def batch(seed, s):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in synthetic_mnist(LENET_BATCH, s, seed=seed).items()}

    p0 = init(0)
    prof = profile_fn(step, p0, opt.init(p0), batch(0, 0),
                      torch.tensor(0.05, device=dev))
    log(f"[train-lenet] one LeNet-4 step at batch {LENET_BATCH}: "
        f"{prof.flops / 1e6:.1f} MFLOP, resident {prof.resident_bytes / 1e6:.2f}"
        f" MB (arguments {prof.argument_bytes / 1e6:.2f}, temporaries "
        f"{prof.temp_bytes / 1e6:.2f}, outputs {prof.output_bytes / 1e6:.2f});"
        f" 8 packed {8 * prof.resident_bytes / 1e6:.1f} MB, fits 80 GB "
        f"{prof.fits(80e9 / 8)}")
    if not (prof.flops > 0 and prof.temp_bytes > 0 and prof.fits(80e9 / 8)):
        raise AssertionError("profile_fn: no FLOPs or temporaries measured")

    jobs = packing.PackedJobs.create(
        lenet.init, opt.init, step, torch.Generator(device=dev).manual_seed(0),
        n_lanes=8, hparams=torch.tensor([0.01 * (i + 1) for i in range(8)],
                                        device=dev))
    means = []
    for s in range(10):
        m = jobs.run_step(packing.stack_trees([batch(i, s) for i in range(8)]))
        if not torch.isfinite(m["loss"]).all():
            raise AssertionError(f"PackedJobs step {s}: non-finite losses")
        means.append(float(m["loss"].mean()))
    log(f"[train-lenet] PackedJobs, 8 lanes, lr 0.01*(i+1), 10 steps: mean "
        f"loss {means[0]:.4f} -> {means[-1]:.4f}; final per-lane "
        f"{[round(float(x), 3) for x in m['loss']]}")
    if not means[-1] < means[0]:
        raise AssertionError("PackedJobs: the mean loss did not fall")

    budgets = [int(b) for b in np.random.default_rng(0).integers(2, 13, 24)]

    def tasks():
        return [LaneTask(id=i, hparams=torch.tensor(0.01 * (1 + i % 8),
                                                    device=dev),
                         init_fn=lambda i=i: (lambda q: (q, opt.init(q)))(
                             init(100 + i)),
                         batch_fn=lambda s, i=i: synthetic_mnist(
                             LENET_BATCH, s, seed=i),
                         steps=b) for i, b in enumerate(budgets)]

    def pool(cap, mode="where"):
        tmpl = init(0)
        return LanePool(cap, step, template_params=tmpl,
                        template_opt=opt.init(tmpl),
                        template_hparams=torch.tensor(0.0, device=dev),
                        exec_mode=mode)

    runs = {}
    for mode in ("where", "compact"):
        losses, stats, _, wall = _run_refill(pool(8, mode), tasks())
        runs[mode] = losses
        log(f"[train-lenet] RefillExecutor {mode}, 24 tasks, budgets "
            f"{min(budgets)}-{max(budgets)} (sum {sum(budgets)}), capacity "
            f"8: lane_steps {stats.lane_steps}, global_steps "
            f"{stats.global_steps}, mean active lanes {stats.occupancy:.2f}, "
            f"n_traces {stats.n_traces}, wall {wall:.2f} s")
        if stats.lane_steps != sum(budgets):
            raise AssertionError(f"{mode}: lane_steps {stats.lane_steps} != "
                                 f"sum of budgets {sum(budgets)}")
        if stats.n_traces > (1 if mode == "where" else 4):
            raise AssertionError(f"{mode}: {stats.n_traces} step programs")
    _compare_losses("where vs compact", runs["compact"], runs["where"])

    first, st1, ex1, _ = _run_refill(
        pool(8), tasks(), should_preempt=lambda st: st.global_steps == 5)
    if not (st1.preempted and ex1.snapshot.lanes):
        raise AssertionError("the run did not drain at global step 5")
    with tempfile.TemporaryDirectory() as tmp:
        ex1.snapshot.save(tmp, step=5)
        tmpl = init(0)
        snap = PoolSnapshot.load(tmp, tmpl, opt.init(tmpl),
                                 torch.tensor(0.0, device=dev))
    rest, st2, _, _ = _run_refill(pool(4), rehydrate(snap, tasks()))
    resumed = {t: first.get(t, []) + rest.get(t, []) for t in runs["where"]}
    log(f"[train-lenet] preempted at global step 5 ({len(snap.lanes)} lanes "
        f"in flight, {len(snap.queued)} queued), saved, loaded, resumed at "
        f"capacity 4: lane_steps {st1.lane_steps} + {st2.lane_steps}; final "
        f"losses of tasks 0-3 {[round(resumed[t][-1], 4) for t in range(4)]}"
        f" vs {[round(runs['where'][t][-1], 4) for t in range(4)]}")
    if st1.lane_steps + st2.lane_steps != sum(budgets):
        raise AssertionError("resume: lane steps lost or repeated")
    _compare_losses("resumed at capacity 4 vs uninterrupted", resumed,
                    runs["where"])

    # the paper's Figs 4-5: packed step time against concurrency
    times = {}
    for conc in (1, 2, 4, 8, 12, 24):
        gen = torch.Generator(device=dev).manual_seed(conc)
        params = packing.pack_init(lenet.init, [gen] * conc)
        ostate = packing.stack_trees([opt.init(packing.lane_slice(params, i))
                                      for i in range(conc)])
        b = packing.stack_trees([batch(i, 0) for i in range(conc)])
        lrs = torch.full((conc,), 0.05, device=dev)
        packed = packing.packed_step(step)
        walls = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, ostate, _ = packed(params, ostate, b, lrs)
            torch.cuda.synchronize()
            if i >= 2:
                walls.append(1e3 * (time.perf_counter() - t0))
        times[conc] = float(np.median(walls))
    log(f"[train-lenet] packed LeNet-4 step vs concurrency (batch "
        f"{LENET_BATCH} per task, median of 5; x = t1*conc/t_conc): "
        + ", ".join(
            f"{c}: {t:.2f} ms (x{times[1] * c / t:.2f})"
            for c, t in times.items()))

    full = pool(8)
    for i, t in enumerate(tasks()[:8]):
        full.attach(i, t.id, *t.init_fn(), t.hparams)
    full_batch = packing.stack_trees([batch(i, 0) for i in range(8)])
    return full, full_batch


def kernel_pool_step(params, opt_state, batch, hp, active):
    """benchmarks/bench_kernels.py::_pool_step on the port: the two GEMMs
    of a per-lane linear regression step (forward and hand-written
    gradient) through the lane-masked packed GEMM. The CPU tests hold this
    same function against the other modes."""
    from repro_torch.kernels import ops
    pred = ops.packed_matmul(batch["x"], params["w"], active=active)
    err = pred - batch["y"]
    xt = batch["x"].transpose(-1, -2)
    grad = ops.packed_matmul(xt, err, active=active) / batch["x"].shape[-2]
    loss = (err * err).mean(dim=(-1, -2))
    return ({"w": params["w"] - hp.reshape(-1, 1, 1) * grad},
            {"m": opt_state["m"] * 0.9 + loss * 0.1}, {"loss": loss})


def lane_step(params, opt_state, batch, hp):
    """benchmarks/bench_kernels.py::_lane_step: the same step on one lane
    (the "where" and "compact" modes vmap it)."""
    pred = batch["x"] @ params["w"]
    err = pred - batch["y"]
    grad = batch["x"].T @ err / batch["x"].shape[0]
    loss = (err * err).mean()
    return ({"w": params["w"] - hp * grad},
            {"m": opt_state["m"] * 0.9 + loss * 0.1}, {"loss": loss})


def occupancy_mask(J: int, occupancy: float, seed: int) -> np.ndarray:
    """benchmarks/bench_kernels.py::_mask."""
    k = max(1, int(round(J * occupancy)))
    rng = np.random.Generator(np.random.Philox(key=seed))
    m = np.zeros((J,), bool)
    m[rng.permutation(J)[:k]] = True
    return m


def train_kernel(record: dict) -> tuple:
    """The lane pool's "kernel" mode at J=16, d=o=nb=256, f32, at
    occupancies 0.25 / 0.5 / 1.0; sets ``record["launches"]`` (B1) from
    the pool's own steps, counted before any step that checks them runs.
    Returns the kernel-mode step and its full-occupancy arguments, for the
    profile."""
    import torch
    from repro_torch.core import packing
    from repro_torch.core.lanepool import LanePool
    J, d, o, nb = KERNEL_POOL
    gen = torch.Generator(device="cuda").manual_seed(3)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    params, opt = {"w": mk(J, d, o)}, {"m": torch.zeros(J, device="cuda")}
    hp = torch.full((J,), 1e-2, device="cuda")
    batch = {"x": mk(J, nb, d), "y": mk(J, nb, o)}
    pool = LanePool(J, kernel_pool_step,
                    template_params=packing.lane_slice(params, 0),
                    template_opt=packing.lane_slice(opt, 0),
                    template_hparams=torch.tensor(0.0, device="cuda"),
                    exec_mode="kernel")
    masks = {occ: occupancy_mask(J, occ, J * 100 + int(occ * 100))
             for occ in (0.25, 0.5, 1.0)}

    # the main path: one pool step per occupancy, nothing else launched
    # between the reset and the read
    reset_launches()
    runs = []
    for occ, mask in masks.items():
        for lane in pool.active_lanes():
            pool.detach(lane)
        for lane in np.flatnonzero(mask):
            pool.attach(int(lane), int(lane), packing.lane_slice(params, lane),
                        packing.lane_slice(opt, lane), hp[lane])
        before = tuple(packing.tree_copy(t) for t in
                       (pool.params, pool.opt_state, pool.hparams))
        pool.step(batch)
        runs.append((occ, mask, before, packing.tree_copy(pool.params)))
    from repro_torch.kernels import packed_gemm as pg
    launches = read_launches()
    by_body = dict(pg.packed_gemm_cuda.launches_by_body)
    record["launches"] = launches["packed_gemm"]
    record["launches_by_body"] = by_body
    log(f"[train-kernel] launches in the pool's run: {launches}; packed_gemm "
        f"by body {by_body}; kernel-mode pool steps {len(runs)}, n_traces "
        f"{pool.n_traces}")
    if launches["packed_gemm"] != 2 * len(runs) \
            or by_body["simt"] != launches["packed_gemm"]:
        raise AssertionError(f"packed_gemm launched {launches['packed_gemm']}"
                             f" times ({by_body}) for {len(runs)} f32 "
                             f"kernel-mode pool steps")

    dense = packing.masked_pool_step(kernel_pool_step, mode="kernel")
    where = packing.masked_pool_step(lane_step, mode="where")
    ones = np.ones((J,), bool)
    for occ, mask, before, after in runs:
        kd, _, _ = dense(*before[:2], batch, before[2], ones)
        wp, _, _ = where(*before[:2], batch, before[2], mask)
        act, inact = np.flatnonzero(mask), np.flatnonzero(~mask)
        got = after["w"]
        if not torch.equal(got[act], kd["w"][act]):
            raise AssertionError(f"kernel mode occ {occ}: active lanes differ "
                                 f"from the all-ones step")
        if not torch.equal(got[inact], before[0]["w"][inact]):
            raise AssertionError(f"kernel mode occ {occ}: inactive lanes "
                                 f"changed")
        err = (got[act] - wp["w"][act]).abs().max().item()
        if not torch.allclose(got[act], wp["w"][act], **MODE_TOL):
            raise AssertionError(f"kernel vs where at occ {occ}: {err}")
        log(f"[train-kernel] occupancy {occ} ({act.size}/{J} lanes): active "
            f"lanes bit-equal to the all-ones step, inactive lanes "
            f"untouched, vs where max diff {err:.3g} (rtol=atol="
            f"{MODE_TOL['rtol']})")

    compact = packing.masked_pool_step(lane_step, mode="compact")
    for occ, mask in masks.items():
        row = {}
        for name, fn in (("where", where), ("compact", compact),
                         ("kernel", dense)):
            row[name] = cuda_time_ms(
                lambda: fn(params, opt, batch, hp, mask), iters=10)
        log(f"[train-kernel] pool step at occupancy {occ}: where "
            f"{row['where']:.4f} ms, compact {row['compact']:.4f} ms, kernel "
            f"{row['kernel']:.4f} ms")
    return dense, params, opt, batch, hp, ones


def profile_training(lenet_pool, lenet_batch, kernel_args) -> None:
    """Where the time goes in one full 8-lane LeNet-4 pool step ("where")
    and one full kernel-mode step (``profile_calls``)."""
    fn, params, opt, batch, hp, mask = kernel_args
    profile_calls((
        ("LeNet-4 pool step, 8 lanes, where",
         lambda: lenet_pool.step(lenet_batch)),
        ("kernel-mode step, J=16, all lanes",
         lambda: fn(params, opt, batch, hp, mask))))


# ---------------------------------------------------------------------------
# phase 7: the transformer sweep
# ---------------------------------------------------------------------------

def lm_batch_fn(cfg, seq: int, batch: int):
    """``batch_fn(seed, step)`` of a sweep: ``SyntheticLM`` batches."""
    from repro_torch.data import SyntheticLM
    return lambda seed, step: SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch,
        seed=seed).batch(step)


def lm_pool(model, k: int, batch_fn, opt=None):
    """A ``LanePool`` of k lanes of ``model`` under ``opt`` (default AdamW:
    run_sweep's step and optimizer), every lane attached, and its stacked
    batch of step 0."""
    import torch
    from repro_torch import optim
    from repro_torch.core import packing
    from repro_torch.core.lanepool import LanePool
    from repro_torch.launch.train import make_train_step
    opt = opt or optim.adamw(weight_decay=0.0)
    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)
    tmpl = model.init(gen(0))
    pool = LanePool(k, make_train_step(model, opt), template_params=tmpl,
                    template_opt=opt.init(tmpl),
                    template_hparams=torch.tensor(0.0, device="cuda"))
    del tmpl
    for lane in range(k):
        params = model.init(gen(lane))
        pool.attach(lane, lane, params, opt.init(params), torch.tensor(1e-3))
        del params
    batch = packing.stack_trees([packing.tree_map(
        lambda x: torch.as_tensor(x, device="cuda"), batch_fn(lane, 0))
        for lane in range(k)])
    return pool, batch


def lm_peaks(model, k: int, batch_fn) -> dict:
    """Device bytes of a k-lane pool of ``model``, each as (total, above
    what the pool held before the call): "held" is what the gradient keeps
    from the end of its forward for its backward (what remat changes),
    "gradient" the peak of ``vmap(grad)`` of the loss, "pool step" the peak
    of one masked pool step, and "garbage" what that step left that only
    the garbage collector frees (a reference cycle holding tensors). The
    collector runs before each call, so that it frees nothing inside one."""
    import gc

    import torch
    pool, batch = lm_pool(model, k, batch_fn)
    held = []

    def loss(params, batch):
        out = model.loss(params, batch)[0]
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
        return out
    grad = torch.func.vmap(torch.func.grad(loss))
    out, before = {}, {}
    for name, fn in (("gradient", lambda: grad(pool.params, batch)),
                     ("pool step", lambda: pool.step(batch))):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before[name] = torch.cuda.memory_allocated()
        res = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del res
        out[name] = (peak, peak - before[name])
        if name == "gradient":
            out["held"] = (held[0], held[0] - before[name])
    after = torch.cuda.memory_allocated()
    gc.collect()
    out["garbage"] = after - torch.cuda.memory_allocated()
    del pool, batch
    return out


# kernel kinds by name: B3; cuDNN's convolutions (its layout transposes
# and FFT products among them); the GEMMs (cuBLAS and CUTLASS names);
# reductions; copies, casts and layout changes; the rest elementwise
KERNEL_KINDS = (("B3", ("fa_fwd",)),
                ("conv (cuDNN)", ("cudnn", "fprop", "dgrad", "wgrad",
                                  "pointwise_mult_and_sum_complex")),
                ("GEMM", ("gemm", "cutlass", "xmma", "nvjet", "sm90_")),
                ("reduction", ("reduce", "norm_kernel")),
                ("copy/cast", ("copy", "cat", "index", "scatter", "gather",
                               "fill")))


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "elementwise"


def log_by_kind(by_name: dict) -> float:
    """Logs a profile's kernel time by ``kernel_kind``; returns the total."""
    busy = sum(ms for ms, _ in by_name.values())
    kinds: dict = {}
    for name, (ms, n) in by_name.items():
        kind = kernel_kind(name)
        kinds[kind] = tuple(a + b for a, b in zip(kinds.get(kind, (0, 0)),
                                                  (ms, n)))
    log("[profile] by kind: " + ", ".join(
        f"{kind} {ms:.2f} ms ({ms / busy:.1%}, x{n})" for kind, (ms, n) in
        sorted(kinds.items(), key=lambda kv: -kv[1][0])))
    return busy


def cpu_drawn_model(cfg, device):
    """A ``models.model.Model`` whose ``init`` draws on the CPU from the
    generator's seed and moves the params to the model's device, so a card
    sweep and a CPU sweep start from the same values (a CUDA generator
    draws other numbers than a CPU one)."""
    import torch
    from repro_torch.models.model import Model

    class CpuDrawn(Model):
        def init(self, generator):
            params = Model(self.cfg, self.pctx, device="cpu").init(
                torch.Generator().manual_seed(generator.initial_seed()))
            return _tree_to(params, self.device)
    return CpuDrawn(cfg, device=device)


def check_small_families() -> None:
    """[small] the reduced vlm and encdec configs (f32, head dim 16: B3's
    simt body) on the card through the kernels and on the CPU through the
    chunked paths, from the same parameters, on request 0 of their serving
    phase's requests: prefill logits, then 3 greedy decode steps' logits
    and tokens; and the reduced ResNet-18 (width 0.25, 16 px, batch 2):
    logits, loss, and two steps of a 2-lane ``packed_step``."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model
    for name, make in (("qwen2-vl-7b", vlm_requests),
                       ("seamless-m4t-medium", encdec_requests)):
        cfg = configs.get(name).reduced()
        r = make(cfg.vocab_size, cfg.d_model)[0]
        cpu_model = Model(cfg, device="cpu")
        cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
        gpu_model = Model(cfg, device="cuda")
        gpu_params = _tree_to(cpu_params, "cuda")
        before = fa.flash_attention_cuda.launches_by_body["simt"]
        runs = []
        for model, params in ((cpu_model, cpu_params),
                              (gpu_model, gpu_params)):
            batch = embeds_batch(model, params, r)
            logits, cache = model.prefill(params, batch, max_len=r.max_len)
            runs.append(([logits.cpu()], cache, params, model, batch))
        launched = fa.flash_attention_cuda.launches_by_body["simt"] - before
        S = batch["tokens" if cfg.is_encdec else "embeds"].shape[1]
        for i in range(3):
            tok = runs[0][0][-1].argmax(-1)[:, None]
            for logs, cache, params, model, batch in runs:
                logs.append(model.decode_step(params, embeds_step(
                    model, r, batch, tok, i), cache)[0].cpu())
        errs = [(g - c).abs().max().item()
                for g, c in zip(runs[1][0], runs[0][0])]
        same = all(int(g.argmax()) == int(c.argmax())
                   for g, c in zip(runs[1][0], runs[0][0]))
        log(f"[small] {cfg.name}: f32 prefill (S {S}) and 3 decode steps' "
            f"logits card (kernels; B3 simt {launched} launches) vs cpu "
            f"(chunked): max_abs_err {[f'{e:.3g}' for e in errs]} (atol "
            f"{SMALL_LOGIT_ATOL_F32}), tokens equal {same}")
        if max(errs) > SMALL_LOGIT_ATOL_F32 or not same \
                or launched != blocks_of(cfg)[0]:
            raise AssertionError(f"small {cfg.name}: card and cpu differ "
                                 f"({errs}, tokens equal {same}) or B3 "
                                 f"launches {launched} != "
                                 f"{blocks_of(cfg)[0]}")
    check_small_resnet()


def check_small_resnet() -> None:
    """The reduced ResNet-18 (width 0.25, 1000 classes, 16 px, batch 2)
    from the same CPU-drawn params on the card and on the CPU: logits and
    loss, then two steps of a 2-lane ``packed_step`` (SGD): losses and
    params within ``XDEV_LOSS_TOL`` (f32 convs in other orders; TF32
    off)."""
    import torch
    from repro_torch import optim
    from repro_torch.core import packing
    from repro_torch.data import synthetic_imagenet
    from repro_torch.models import resnet
    opt = optim.sgd()
    step = packing.packed_step(resnet_step(opt))
    lanes = [resnet.init(torch.Generator().manual_seed(i), 0.25,
                         device="cpu") for i in range(2)]
    batches = [packing.stack_trees([
        {k: torch.from_numpy(v) for k, v in synthetic_imagenet(
            2, s, seed=i, res=16).items()} for i in range(2)])
        for s in range(2)]
    out = []
    for dev in ("cpu", "cuda"):
        params = _tree_to(packing.stack_trees(lanes), dev)
        opt_state = _tree_to(packing.stack_trees(
            [opt.init(p) for p in lanes]), dev)
        lane0 = _tree_to(lanes[0], dev)
        image = batches[0]["image"][0].to(dev)
        logits = resnet.apply(lane0, image).cpu()
        losses = []
        for b in batches:
            params, opt_state, m = step(params, opt_state, _tree_to(b, dev),
                                        torch.full((2,), 0.1, device=dev))
            losses.append(m["loss"].cpu())
        out.append((logits, torch.stack(losses),
                    [t.cpu() for t in _leaves(params)]))
    (lc, sc, pc), (lg, sg, pg) = out
    errs = ((lg - lc).abs().max().item(), (sg - sc).abs().max().item(),
            max((g - c).abs().max().item() for g, c in zip(pg, pc)))
    ok = (torch.allclose(lg, lc, **XDEV_LOSS_TOL)
          and torch.allclose(sg, sc, **XDEV_LOSS_TOL)
          and all(torch.allclose(g, c, **XDEV_LOSS_TOL)
                  for g, c in zip(pg, pc)))
    log(f"[small] resnet-18 width 0.25, 16 px: card vs cpu max_abs_err "
        f"logits {errs[0]:.3g}, 2-lane packed_step losses {errs[1]:.3g}, "
        f"params after 2 steps {errs[2]:.3g} (allclose {XDEV_LOSS_TOL})")
    if not ok:
        raise AssertionError(f"small resnet: card and cpu differ {errs}")


def train_resnet() -> None:
    """[train-resnet] the paper's §III-B ladder: ResNet-18 at width 1.0,
    1000 classes, 224-px ``synthetic_imagenet`` images, SGD under
    ``packing.packed_step`` (a plain ``vmap``, no hand-written kernel) at
    NPPN 1, 2, 4 and 6, ``RESNET_STEPS`` steps a wave; 12 tasks run in
    ceil(12 / NPPN) waves, timed as ``benchmarks/bench_imagenet_sharing.py``
    times them (median of 3 waves after one warm-up). Logs for each NPPN the
    individual time, job elapsed, speedup over NPPN 1, and
    ``monitor.profile_fn``'s bytes(1) x NPPN (the paper's linear memory
    model) beside the wave's measured peak above what was held before the
    lanes were built. Gates: TF32 off; every loss finite; each lane's
    per-step losses within ``RESNET_LOSS_TOL`` of the same task run alone
    (NPPN 1). The per-lane batch is the largest power of two from
    ``RESNET_BATCH`` for which bytes(1) x 6 stays within
    ``TRAIN_LM_HBM_FRACTION`` of the card. Then a [profile] of one pool
    step at NPPN 6."""
    import gc

    import torch
    from repro_torch import optim
    from repro_torch.core import packing
    from repro_torch.core.monitor import profile_fn
    from repro_torch.data import synthetic_imagenet
    from repro_torch.models import resnet
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("train-resnet: TF32 is on")
    gc.collect()
    torch.cuda.empty_cache()
    opt = optim.sgd()
    step = resnet_step(opt)
    init = lambda i: resnet.init(torch.Generator(device="cuda").manual_seed(i))
    data = lambda b, lane, s: {k: torch.from_numpy(v).cuda() for k, v in
                               synthetic_imagenet(b, s, seed=lane,
                                                  res=224).items()}
    lr = torch.tensor(0.1, device="cuda")
    total = torch.cuda.get_device_properties(0).total_memory
    budget = TRAIN_LM_HBM_FRACTION * total
    p0 = init(0)
    o0 = opt.init(p0)
    measured = {}

    def bytes1(b):
        if b not in measured:
            gc.collect()
            prof = profile_fn(step, p0, o0, data(b, 0, 0), lr)
            measured[b] = (prof.resident_bytes, prof.flops)
        return measured[b][0]
    batch = RESNET_BATCH
    while batch > 1 and max(RESNET_NPPN) * bytes1(batch) > budget:
        batch //= 2
    while batch < 4 * RESNET_BATCH and \
            max(RESNET_NPPN) * bytes1(2 * batch) <= budget:
        batch *= 2
    b1, flops = measured[batch]
    n_params = sum(t.numel() for t in _leaves(p0))
    log(f"[train-resnet] resnet-18 width 1.0: {n_params / 1e6:.2f} M params,"
        f" 224 px, 1000 classes, SGD; per-lane batch {batch} (cut from the "
        f"paper's 256): bytes(1) by batch "
        f"{ {b: round(v[0] / 1e9, 3) for b, v in sorted(measured.items())} }"
        f" GB, x {max(RESNET_NPPN)} within {TRAIN_LM_HBM_FRACTION:.0%} of "
        f"{total / 1e9:.1f} GB; {flops / 1e12:.3f} TFLOP a lane-step "
        f"(FlopCounterMode)")
    del p0, o0
    packed = packing.packed_step(step)

    def pool(tasks):
        """Lanes of ``tasks``: task i's params from torch seed i, its
        batches from numpy seed i."""
        lanes = [init(i) for i in tasks]
        return (packing.stack_trees(lanes),
                packing.stack_trees([opt.init(p) for p in lanes]),
                [packing.stack_trees([data(batch, i, s) for i in tasks])
                 for s in range(RESNET_STEPS)],
                torch.full((len(tasks),), 0.1, device="cuda"))

    def wave(params, opt_state, batches, lrs):
        losses = []
        for b in batches:
            params, opt_state, m = packed(params, opt_state, b, lrs)
            losses.append(m["loss"])
        return torch.stack(losses)

    alone = {i: wave(*pool([i]))[:, 0].cpu()
             for i in range(max(RESNET_NPPN))}
    results = {}
    for conc in RESNET_NPPN:
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        args = pool(range(conc))
        losses = wave(*args).cpu()
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wave(*args)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        t = sorted(ts)[1]
        peak = torch.cuda.max_memory_allocated() - base
        waves = -(-RESNET_TASKS // conc)
        results[conc] = (t, t * waves)
        gaps = [(losses[:, i] - alone[i]).abs().max().item()
                for i in range(conc)]
        ok = torch.isfinite(losses).all() and all(
            torch.allclose(losses[:, i], alone[i], **RESNET_LOSS_TOL)
            for i in range(conc))
        log(f"[train-resnet] NPPN {conc}: individual time {t:.4f} s "
            f"({RESNET_STEPS} steps; waves {min(ts):.4f}-{max(ts):.4f}), job "
            f"elapsed {t * waves:.4f} s ({waves} waves), speedup "
            f"{results[1][1] / (t * waves):.3f}; memory predicted "
            f"bytes(1) x {conc} = {b1 * conc / 1e9:.3f} GB, measured peak "
            f"above the held bytes {peak / 1e9:.3f} GB "
            f"({peak / (b1 * conc):.3f} of it); losses {losses.tolist()}, "
            f"max gap to each task alone {max(gaps):.3g} (allclose "
            f"{RESNET_LOSS_TOL})")
        if not ok:
            raise AssertionError(f"train-resnet NPPN {conc}: losses "
                                 f"{losses.tolist()} not finite or off "
                                 f"their tasks alone {alone}")
        if conc == max(RESNET_NPPN):
            params, opt_state, batches, lrs = args
            del args
            log_by_kind(profile_calls(((
                f"resnet-18 pool step, NPPN {conc} x batch {batch}",
                lambda: packed(params, opt_state, batches[0], lrs)),))[0][1])
            del params, opt_state, batches, lrs
        else:
            del args
    gc.collect()
    conv_layouts(max(RESNET_NPPN), batch)


def conv_layouts(lanes: int, batch: int) -> None:
    """What ``vmap`` makes of a lane's convolution: one 3x3 conv of stage 1
    (64 -> 64 channels at 224², f32), forward and backward, as the lanes'
    grouped convolution (``groups=lanes``, what the batching rule of
    ``F.conv2d`` with per-lane weights runs) in NCHW and in channels-last,
    against one lane's convolution run ``lanes`` times (CUDA events)."""
    import torch
    import torch.nn.functional as F
    C, H = 64, 224
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    times = {}
    for fmt in (torch.contiguous_format, torch.channels_last):
        for n in (lanes, 1):
            x = rand(batch, n * C, H, H).contiguous(
                memory_format=fmt).requires_grad_()
            w = rand(n * C, C, 3, 3).contiguous(
                memory_format=fmt).requires_grad_()
            g = rand(batch, n * C, H, H).contiguous(memory_format=fmt)
            times[fmt, n] = cuda_time_ms(lambda: torch.autograd.grad(
                F.conv2d(x, w, padding=1, groups=n), (x, w), g), iters=5)
            del x, w, g
    log(f"[train-resnet] one stage-1 conv (batch {batch}, 64 -> 64, 224², "
        f"f32) forward and backward, {lanes} lanes: grouped NCHW "
        f"{times[torch.contiguous_format, lanes]:.2f} ms, grouped "
        f"channels-last {times[torch.channels_last, lanes]:.2f} ms; one "
        f"lane x {lanes}: NCHW "
        f"{lanes * times[torch.contiguous_format, 1]:.2f} ms, channels-last "
        f"{lanes * times[torch.channels_last, 1]:.2f} ms")


def train_lm_small() -> None:
    """Drain and resume, adaptive packing, and card against CPU on the
    reduced StableLM-2 (f32, head dim 16: B3's f32 body)."""
    import tempfile

    from repro_torch import configs
    from repro_torch.core.repack import RepackPolicy
    from repro_torch.launch.sweep import SweepTask, run_sweep
    cfg = configs.get("stablelm-1.6b").reduced()
    model = cpu_drawn_model(cfg, "cuda")
    bf = lm_batch_fn(cfg, 16, 2)
    tasks = lambda n: [SweepTask(id=i, lr=1e-3, seed=i) for i in range(n)]
    base = run_sweep(model, tasks(4), batch_fn=bf, steps=6, max_pack=4)
    with tempfile.TemporaryDirectory() as ck:
        part = run_sweep(model, tasks(4), batch_fn=bf, steps=6, max_pack=4,
                         checkpoint_dir=ck,
                         preempt=lambda st: st.global_steps >= 3)
        res = run_sweep(model, tasks(4), batch_fn=bf, steps=6, max_pack=2,
                        checkpoint_dir=ck)
    if not part.preempted or res.preempted \
            or part.global_steps != 3 or res.pack_factor != 2:
        raise AssertionError(f"drain/resume: preempted {part.preempted}, "
                             f"{res.preempted}; steps {part.global_steps}")
    resumed = {i: part.losses[i] + res.losses[i] for i in base.losses}
    log(f"[train-lm] {cfg.name}: drained at global step "
        f"{part.global_steps} (pack 4), resumed at max_pack=2: lane_steps "
        f"{part.lane_steps} + {res.lane_steps} of {base.lane_steps}")
    _compare_losses("drain + resume at max_pack=2 vs uninterrupted",
                    resumed, base.losses, phase="train-lm")

    static = run_sweep(model, tasks(6), batch_fn=bf, steps=4, max_pack=6)
    ad = run_sweep(model, tasks(6), batch_fn=bf, steps=4, max_pack=6,
                   adaptive_pack=True, repack_policy=RepackPolicy(
                       start_capacity=2, grow_occupancy=0.5,
                       shrink_occupancy=0.1, cooldown_steps=1,
                       max_capacity=6))
    log(f"[train-lm] adaptive_pack: repacks {ad.repacks}, capacity_trace "
        f"{ad.capacity_trace}, pack_factor {ad.pack_factor}, n_traces "
        f"{ad.n_traces}, lane_steps {ad.lane_steps} vs {static.lane_steps}")
    if ad.repacks < 1 or ad.lane_steps != static.lane_steps:
        raise AssertionError("adaptive_pack: no repack or lane steps lost")
    _compare_losses("adaptive_pack vs static pack 6", ad.losses,
                    static.losses, phase="train-lm")

    cpu = run_sweep(cpu_drawn_model(cfg, "cpu"), tasks(4), batch_fn=bf,
                    steps=6, max_pack=4)
    _compare_losses("card (B3 f32 body) vs cpu (chunked)", base.losses,
                    cpu.losses, tol=XDEV_LOSS_TOL, phase="train-lm")


def log_loss_gaps(what: str, losses: dict, ref: dict) -> float:
    """Log the largest |losses - ref| by task and by step; return the
    largest relative gap."""
    gaps = {i: np.abs(np.float32(v) - np.float32(ref[i]))
            for i, v in losses.items()}
    steps = max(g.size for g in gaps.values())
    log(f"[train-lm] largest |{what}| loss gap by task: " + ", ".join(
        f"{i} (lr {TRAIN_LM_LRS[i]:.1e}): {g.max():.4f}"
        for i, g in gaps.items()) + "; by step: " + ", ".join(
        f"{s}: {max(g[s] for g in gaps.values() if s < g.size):.4f}"
        for s in range(steps)))
    return max(float((g / np.abs(np.float32(ref[i]))).max())
               for i, g in gaps.items())


def log_remat_peaks(setting: str, peaks: dict,
                    phase: str = "train-lm") -> None:
    """Log ``lm_peaks``' readings with remat (``peaks[True]``) against
    without (``peaks[False]``)."""
    for name, what in (("held", "held from forward to backward"),
                       ("gradient", "gradient peak"),
                       ("pool step", "pool step peak")):
        (pt, dt), (pf, df) = peaks[True][name], peaks[False][name]
        log(f"[{phase}] {setting} {what}: {pt / 1e9:.3f} GB with remat "
            f"({dt / 1e9:.3f} above the pool), {pf / 1e9:.3f} GB without "
            f"({df / 1e9:.3f}); ratio {pt / pf:.3f} ({dt / df:.3f} above "
            f"the pool)")
    log(f"[{phase}] {setting}: left by a pool step for the garbage "
        f"collector {peaks[True]['garbage'] / 1e9:.3f} GB with remat, "
        f"{peaks[False]['garbage'] / 1e9:.3f} without")


def train_lm(record: dict) -> None:
    """``run_sweep`` over full-width StableLM-2 (4 layers) on the card:
    auto_nppn picks the pack factor from measured bytes, 8 tasks of skewed
    budgets train as lanes of one refilled pool through B3. Sets
    ``record["launches_train_lm"]`` from the sweep's run."""
    import torch
    from repro_torch import configs
    from repro_torch.core.faults import FaultPolicy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.sweep import SweepTask, run_sweep
    from repro_torch.models import ParallelCtx, build_model
    full = configs.get("stablelm-1.6b")
    cfg = dataclasses.replace(full, num_layers=TRAIN_LM_LAYERS)
    n, n_full = cfg.param_count(), full.param_count()
    log(f"[train-lm] {cfg.name} at its published width: d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.resolved_head_dim}, "
        f"d_ff {cfg.d_ff} {cfg.mlp_type}, vocab {cfg.vocab_size}, "
        f"{cfg.param_dtype} params, {cfg.compute_dtype} compute, remat="
        f"{cfg.remat}; depth cut from {full.num_layers} to {cfg.num_layers} "
        f"layers ({n / 1e6:.1f} M params, {16 * n / 1e9:.2f} GB of f32 "
        f"params, grads and AdamW moments a lane; {16 * n_full / 1e9:.1f} "
        f"GB at full depth)")
    bf = lm_batch_fn(cfg, TRAIN_LM_SEQ, TRAIN_LM_BATCH)
    budgets = TRAIN_LM_BUDGETS

    def tasks():
        return [SweepTask(id=i, lr=lr, seed=i, steps=b)
                for i, (lr, b) in enumerate(zip(TRAIN_LM_LRS, budgets))]
    total = torch.cuda.mem_get_info()[1]
    budget = TRAIN_LM_HBM_FRACTION * total
    model = build_model(cfg, device="cuda")
    policy = FaultPolicy(oom_backoff=False)   # a pool failure fails the run

    # the main path: counts set to 0 just before the sweep, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = run_sweep(model, tasks(), batch_fn=bf, steps=max(budgets),
                    hbm_budget=budget, policy=policy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    by_body = dict(fa.flash_attention_cuda.launches_by_body)
    b3 = launches["flash_attention_fwd"]
    record["launches_train_lm"] = b3
    record["launches_train_lm_by_body"] = by_body
    d = res.decision
    p1 = d.profile_single.resident_bytes
    slope = (d.profile.resident_bytes - p1) / max(1, d.nppn_per_chip - 1)
    log(f"[train-lm] auto_nppn, hbm_budget {budget / 1e9:.2f} GB "
        f"({TRAIN_LM_HBM_FRACTION:.0%} of {total / 1e9:.2f} GB): bytes(1) "
        f"{p1 / 1e9:.3f} GB measured (arguments "
        f"{d.profile_single.argument_bytes / 1e9:.3f}, temporaries "
        f"{d.profile_single.temp_bytes / 1e9:.3f}, outputs "
        f"{d.profile_single.output_bytes / 1e9:.3f}), "
        f"{slope / 1e9:.3f} GB a further lane; pack factor "
        f"{d.nppn_per_chip} ({d.reason}); probes run {list(d.measured)}, "
        f"predicted {list(d.predicted)}")
    probe_steps = len(d.measured)
    want = (res.global_steps + probe_steps) * 2 * cfg.num_layers
    log(f"[train-lm] 8 tasks, lr {TRAIN_LM_LRS[0]:.0e}..{TRAIN_LM_LRS[-1]:.0e}"
        f", budgets {list(budgets)} (Σ {sum(budgets)}), batch "
        f"{TRAIN_LM_BATCH} x {TRAIN_LM_SEQ}: wall {wall:.2f} s, pack "
        f"{res.pack_factor}, global_steps {res.global_steps}, lane_steps "
        f"{res.lane_steps}, refills {res.refills}, n_traces {res.n_traces}, "
        f"backoffs {res.backoffs}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{launches}; flash_attention by body {by_body} against "
        f"(global_steps {res.global_steps} + probe steps {probe_steps}) x 2 "
        f"x {cfg.num_layers} layers = {want}")
    log(f"[train-lm] first/last loss per task: " + ", ".join(
        f"{i}: {v[0]:.4f}/{v[-1]:.4f}" for i, v in res.losses.items()))
    if res.backoffs or res.n_traces != 1 or res.lane_steps != sum(budgets):
        raise AssertionError(f"sweep counters: backoffs {res.backoffs}, "
                             f"n_traces {res.n_traces}, lane_steps "
                             f"{res.lane_steps}")
    if [len(res.losses[i]) for i in range(8)] != list(budgets) or not all(
            np.isfinite(v).all() for v in res.losses.values()):
        raise AssertionError("per-task losses: wrong counts or not finite")
    if b3 != want or by_body["wgmma"] != b3:
        raise AssertionError(f"flash_attention launched {b3} times "
                             f"({by_body}), want {want} on the wgmma body")

    # the same sweep through sdpa_chunked, at the same pack factor, and
    # its rounding-only twin: sdpa_chunked with P·V in bf16 (as the
    # kernel's wgmma body rounds P), the same function rounded otherwise
    def chunked_sweep(score_bf16: bool):
        reset_launches()
        r = run_sweep(build_model(cfg, ParallelCtx(
            attn_impl="chunked", score_bf16=score_bf16), device="cuda"),
            tasks(), batch_fn=bf, steps=max(budgets),
            max_pack=res.pack_factor, policy=policy)
        if read_launches()["flash_attention_fwd"]:
            raise AssertionError("a chunked sweep launched B3")
        return r
    res_c, res_t = chunked_sweep(False), chunked_sweep(True)
    first = lambda r: {i: v[:1] for i, v in r.losses.items()}
    step0 = dict(rtol=TRAIN_LM_LOSS_RTOL, atol=0.0)
    gap0 = _compare_losses("step-0 losses, B3 vs sdpa_chunked", first(res),
                           first(res_c), tol=step0, phase="train-lm")
    _compare_losses("step-0 losses, sdpa_chunked P·V bf16 vs f32",
                    first(res_t), first(res_c), tol=step0, phase="train-lm")
    gap = _compare_losses("per-task losses, B3 vs sdpa_chunked", res.losses,
                          res_c.losses, tol=dict(rtol=TRAIN_LM_TRAJ_RTOL,
                                                 atol=0.0),
                          phase="train-lm")
    twin = log_loss_gaps("sdpa_chunked P·V bf16 - f32 (rounding only)",
                         res_t.losses, res_c.losses)
    log_loss_gaps("B3 - sdpa_chunked", res.losses, res_c.losses)
    record["train_lm_loss_gap"] = {"step0": gap0, "all": gap,
                                   "rounding_only": twin}

    # what remat holds from forward to backward, and the peaks of the
    # gradient and of one pool step with remat on and off: (1) at the
    # sweep's pack factor, or one lane fewer where the step with remat
    # already takes more than 3/4 of the card; (2) one lane of
    # TRAIN_LM_REMAT_TOKENS tokens, where block activations set the peaks
    k = res.pack_factor
    peaks = {True: lm_peaks(model, k, bf)}
    if k > 1 and peaks[True]["pool step"][0] > 0.75 * total:
        k -= 1
        peaks[True] = lm_peaks(model, k, bf)
    no_remat = build_model(dataclasses.replace(cfg, remat=False),
                           device="cuda")
    peaks[False] = lm_peaks(no_remat, k, bf)
    log_remat_peaks(f"{k}-lane, {TRAIN_LM_BATCH} x {TRAIN_LM_SEQ} tokens a "
                    f"lane", peaks)
    long_bf = lm_batch_fn(cfg, TRAIN_LM_SEQ,
                          TRAIN_LM_REMAT_TOKENS // TRAIN_LM_SEQ)
    long = {True: lm_peaks(model, 1, long_bf),
            False: lm_peaks(no_remat, 1, long_bf)}
    log_remat_peaks(f"1-lane, {TRAIN_LM_REMAT_TOKENS // TRAIN_LM_SEQ} x "
                    f"{TRAIN_LM_SEQ} tokens", long)
    record["train_lm_remat_peaks"] = {
        name: {n: [got[r][n][0] for r in (True, False)]
               for n in ("held", "gradient", "pool step")}
        for name, got in ((f"{k}_lanes", peaks), ("1_lane_long", long))}
    for what, got in (("held", peaks), ("gradient", peaks), ("held", long),
                      ("gradient", long), ("pool step", long)):
        if not got[True][what][1] < got[False][what][1]:
            raise AssertionError(f"remat did not lower the {what} bytes")
    if any(p[r]["garbage"] for p in (peaks, long) for r in p):
        raise AssertionError("a pool step left tensors in a reference "
                             "cycle")

    # where the time goes in one full-width pool step
    k = res.pack_factor
    pool, batch = lm_pool(model, k, bf)
    (wall_ms, by_name), = profile_calls(
        ((f"{cfg.name} x{cfg.num_layers} layers, {k}-lane pool step",
          lambda: pool.step(batch)),))
    busy = log_by_kind(by_name)
    fa_ms, fa_n = map(sum, zip(*[v for name, v in by_name.items()
                                 if "fa_fwd" in name] or [(0.0, 0)]))
    fa_bound, fa_by = attention_bound_ms(
        k * TRAIN_LM_BATCH, TRAIN_LM_SEQ, TRAIN_LM_SEQ, cfg.num_heads,
        cfg.num_kv_heads, cfg.resolved_head_dim, True, 0, torch.bfloat16)
    log(f"[profile] B3 in that step: {fa_ms:.3f} ms in {fa_n} launches, "
        f"{fa_ms / busy:.1%} of the kernels' time, "
        f"{fa_ms / max(fa_n, 1):.4f} ms a launch at "
        f"({k * TRAIN_LM_BATCH}, {TRAIN_LM_SEQ}, {cfg.num_heads}, "
        f"{cfg.resolved_head_dim}) bf16 causal, bound {fa_bound:.4f} ms "
        f"({fa_by})")
    record["train_lm_device_ms"] = fa_ms / max(fa_n, 1)
    record["train_lm_bound_ms"] = fa_bound
    del pool, batch
    train_lm_small()


# ---------------------------------------------------------------------------
# phase 7b: the moe and hybrid training paths, and the roofline
# ---------------------------------------------------------------------------

def _family_tasks():
    from repro_torch.launch.sweep import SweepTask
    return [SweepTask(id=i, lr=lr, seed=i, steps=b) for i, (lr, b) in
            enumerate(zip(TRAIN_FAMILY_LRS, TRAIN_FAMILY_BUDGETS))]


def family_depth(tag: str, full, bf, budget: float, policy):
    """The deepest of ``TRAIN_FAMILY_DEPTHS`` at which ``auto_nppn`` packs
    2 lanes of ``full`` cut to it: a sweep of two one-step tasks with
    ``max_pack=2`` probes each depth. Returns (cfg, model)."""
    from repro_torch.launch.sweep import SweepTask, run_sweep
    from repro_torch.models import build_model
    for L in TRAIN_FAMILY_DEPTHS[full.name]:
        cfg = dataclasses.replace(full, num_layers=L)
        model = build_model(cfg, device="cuda")
        res = run_sweep(model, [SweepTask(id=i, lr=1e-3, seed=i, steps=1)
                                for i in range(2)], batch_fn=bf, steps=1,
                        hbm_budget=budget, max_pack=2, policy=policy)
        d = res.decision
        log(f"[{tag}] depth {L} of {full.num_layers} "
            f"({cfg.param_count() / 1e9:.3f} B params): auto_nppn bytes(1) "
            f"{d.profile_single.resident_bytes / 1e9:.3f} GB, bytes at the "
            f"pack factor {d.profile.resident_bytes / 1e9:.3f} GB, pack "
            f"factor {d.nppn_per_chip} ({d.reason}); probes run "
            f"{list(d.measured)}, predicted {list(d.predicted)}")
        if d.nppn_per_chip >= 2:
            return cfg, model
    raise AssertionError(f"[{tag}] auto_nppn packs 2 lanes at no depth of "
                         f"{TRAIN_FAMILY_DEPTHS[full.name]}")


def check_training_gradient(tag: str, model, bf) -> None:
    """One lane's ``vmap(grad)`` of the loss on the card: finite, and the
    parameters that only a working training path reaches get a gradient:
    the router of every moe layer (through the combine weights and the aux
    term, which must be nonzero), or the shared attention block of the
    hybrid, summed over its applications."""
    import torch
    pool, batch = lm_pool(model, 1, bf)
    grads, (loss, metrics) = torch.func.vmap(torch.func.grad_and_value(
        model.loss, has_aux=True))(pool.params, batch)
    if model.cfg.moe:
        what = grads["blocks"]["moe"]["router"]
        g = what.abs().sum((0, 2, 3))                      # by layer
        aux = float(metrics["aux"][0])
        log(f"[{tag}] one lane's gradient: loss {float(loss[0]):.4f}, ce "
            f"{float(metrics['ce'][0]):.4f}, router aux {aux:.4f} (x "
            f"{model.cfg.moe.router_aux_coef} in the loss); |router grad| "
            f"by layer {[f'{v:.4g}' for v in g.tolist()]}")
        if not (np.isfinite(aux) and aux > 0 and bool((g > 0).all())):
            raise AssertionError(f"[{tag}] aux {aux} or a router gradient "
                                 f"is zero")
    else:
        g = float(grads["hybrid"]["shared"]["attn"]["w_q"].abs().sum())
        log(f"[{tag}] one lane's gradient: loss {float(loss[0]):.4f}; "
            f"|shared attention w_q grad| {g:.4g}")
        if not g > 0:
            raise AssertionError(f"[{tag}] the shared block has no gradient")
    if not all(bool(torch.isfinite(t).all()) for t in _leaves(grads)):
        raise AssertionError(f"[{tag}] a gradient is not finite")
    del pool, batch, grads


def train_family(tag: str, arch: str, record: dict, b4: dict) -> tuple:
    """``run_sweep`` over ``arch`` at its published width (depth from
    ``family_depth``), remat on, AdamW, 4 tasks of skewed budgets on a
    refilled pool packed by ``auto_nppn``, training through B3 (no B4: a
    Mamba2 block trains through the chunked scan). Holds B3's launches to
    2 an attention block a pool step and a probe step (the forward and
    remat's recompute), each task's losses to the task run alone, a
    nonzero router (shared block) gradient, and remat's one-lane peaks;
    profiles one pool step. Returns (model, batch_fn, pack factor)."""
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.core.faults import FaultPolicy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.sweep import run_sweep
    from repro_torch.models import build_model, transformer
    gc.collect()
    torch.cuda.empty_cache()
    full = configs.get(arch)
    bf = lm_batch_fn(full, TRAIN_LM_SEQ, TRAIN_LM_BATCH)
    total = torch.cuda.mem_get_info()[1]
    budget = TRAIN_FAMILY_HBM_FRACTION * total
    policy = FaultPolicy(oom_backoff=False)   # a pool failure fails the run
    width = (f"{full.moe.num_experts} routed experts of "
             f"{full.moe.expert_d_ff} + {full.moe.num_shared_experts} shared, "
             f"top-{full.moe.top_k}, routed dispatch at capacity factor "
             f"{full.moe.capacity_factor}" if full.moe else
             f"Mamba2 {full.ssm.expand * full.d_model // full.ssm.head_dim} "
             f"heads x {full.ssm.head_dim}, N {full.ssm.state_dim}, period "
             f"{full.hybrid_attn_period}, d_ff {full.d_ff}")
    log(f"[{tag}] {arch} at its published width: d_model {full.d_model}, "
        f"{full.num_heads} heads x {full.resolved_head_dim}, {width}, vocab "
        f"{full.vocab_size}, {full.param_dtype} params, {full.compute_dtype} "
        f"compute, remat={full.remat}; hbm_budget {budget / 1e9:.2f} GB "
        f"({TRAIN_FAMILY_HBM_FRACTION:.0%} of {total / 1e9:.2f} GB)")
    cfg, model = family_depth(tag, full, bf, budget, policy)
    if cfg.family == "hybrid":
        n_super, period, n_tail = transformer.hybrid_layout(cfg)
        n_attn = n_super
        cut = (f"{n_super} superblock of {period} Mamba2 blocks and the "
               f"shared block, a tail of {n_tail}")
    else:
        n_attn = cfg.num_layers
        cut = f"{cfg.num_layers} moe layer(s)"
    n = cfg.param_count()
    log(f"[{tag}] depth cut from {full.num_layers} to {cfg.num_layers} "
        f"layers ({cut}): {n / 1e9:.3f} B params, {16 * n / 1e9:.2f} GB of "
        f"f32 params, grads and AdamW moments a lane "
        f"({16 * full.param_count() / 1e9:.1f} GB at full depth)")

    # the main path: counts set to 0 just before the sweep, read just after
    tasks = _family_tasks()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = run_sweep(model, tasks, batch_fn=bf,
                    steps=max(TRAIN_FAMILY_BUDGETS), hbm_budget=budget,
                    policy=policy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    by_body = dict(fa.flash_attention_cuda.launches_by_body)
    b3, b4_calls = launches["flash_attention_fwd"], launches["ssd_scan"]
    d = res.decision
    probe_steps = len(d.measured)
    want = (res.global_steps + probe_steps) * 2 * n_attn
    log(f"[{tag}] {len(tasks)} tasks, lr {TRAIN_FAMILY_LRS[0]:.0e}.."
        f"{TRAIN_FAMILY_LRS[-1]:.0e}, budgets {list(TRAIN_FAMILY_BUDGETS)}, "
        f"batch {TRAIN_LM_BATCH} x {TRAIN_LM_SEQ}: wall {wall:.2f} s, pack "
        f"{res.pack_factor} (bytes(1) "
        f"{d.profile_single.resident_bytes / 1e9:.3f} GB, probes run "
        f"{list(d.measured)}), global_steps {res.global_steps}, lane_steps "
        f"{res.lane_steps}, refills {res.refills}, n_traces {res.n_traces}, "
        f"backoffs {res.backoffs}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{launches}; flash_attention by body {by_body} against "
        f"(global_steps {res.global_steps} + probe steps {probe_steps}) x 2 "
        f"x {n_attn} attention blocks = {want}")
    log(f"[{tag}] first/last loss per task: " + ", ".join(
        f"{i}: {v[0]:.4f}/{v[-1]:.4f}" for i, v in res.losses.items()))
    if res.pack_factor < 2 or res.backoffs or res.n_traces != 1 or \
            res.lane_steps != sum(TRAIN_FAMILY_BUDGETS):
        raise AssertionError(f"[{tag}] sweep: pack {res.pack_factor}, "
                             f"backoffs {res.backoffs}, n_traces "
                             f"{res.n_traces}, lane_steps {res.lane_steps}")
    if [len(res.losses[t.id]) for t in tasks] != list(
            TRAIN_FAMILY_BUDGETS) or not all(
            np.isfinite(v).all() for v in res.losses.values()):
        raise AssertionError(f"[{tag}] per-task losses: wrong counts or not "
                             f"finite")
    if b3 != want or by_body["wgmma"] != b3 or b4_calls:
        raise AssertionError(f"[{tag}] flash_attention launched {b3} times "
                             f"({by_body}), want {want} on the wgmma body; "
                             f"ssd_scan {b4_calls}, want 0")
    record[f"launches_{tag.replace('-', '_')}"] = b3
    b4[f"launches_{tag.replace('-', '_')}"] = b4_calls

    # each task run alone (a pool of one lane): step 0 as [train-lm]'s
    # step-0 bound, the trajectory as its all-step bound
    alone = {t.id: run_sweep(model, [t], batch_fn=bf,
                             steps=max(TRAIN_FAMILY_BUDGETS), max_pack=1,
                             policy=policy).losses[t.id] for t in tasks}
    first = lambda r: {i: v[:1] for i, v in r.items()}
    gap0 = _compare_losses("step-0 losses, packed vs each task alone",
                           first(res.losses), first(alone),
                           tol=dict(rtol=TRAIN_LM_LOSS_RTOL, atol=0.0),
                           phase=tag)
    gap = _compare_losses("per-task losses, packed vs each task alone",
                          res.losses, alone,
                          tol=dict(rtol=TRAIN_LM_TRAJ_RTOL, atol=0.0),
                          phase=tag)
    check_training_gradient(tag, model, bf)

    # remat's readings at one lane, with and without
    peaks = {True: lm_peaks(model, 1, bf)}
    no_remat = build_model(dataclasses.replace(cfg, remat=False),
                           device="cuda")
    peaks[False] = lm_peaks(no_remat, 1, bf)
    log_remat_peaks(f"1-lane, {TRAIN_LM_BATCH} x {TRAIN_LM_SEQ} tokens",
                    peaks, phase=tag)
    for what in ("held", "gradient"):
        if not peaks[True][what][1] < peaks[False][what][1]:
            raise AssertionError(f"[{tag}] remat did not lower the {what} "
                                 f"bytes")
    if any(peaks[r]["garbage"] for r in peaks):
        raise AssertionError(f"[{tag}] a pool step left tensors in a "
                             f"reference cycle")

    # where the time goes in one pool step at the pack factor
    k = res.pack_factor
    pool, batch = lm_pool(model, k, bf)
    (wall_ms, by_name), = profile_calls(
        ((f"{cfg.name} x{cfg.num_layers} layers, {k}-lane pool step",
          lambda: pool.step(batch)),))
    busy = log_by_kind(by_name)
    fa_ms, fa_n = map(sum, zip(*[v for name, v in by_name.items()
                                 if "fa_fwd" in name] or [(0.0, 0)]))
    hd = cfg.resolved_head_dim
    fa_bound, fa_by = attention_bound_ms(
        k * TRAIN_LM_BATCH, TRAIN_LM_SEQ, TRAIN_LM_SEQ, cfg.num_heads,
        cfg.num_kv_heads, hd, True, 0, torch.bfloat16)
    log(f"[profile] B3 in that step: {fa_ms:.3f} ms in {fa_n} launches, "
        f"{fa_ms / busy:.1%} of the kernels' time, "
        f"{fa_ms / max(fa_n, 1):.4f} ms a launch at "
        f"({k * TRAIN_LM_BATCH}, {TRAIN_LM_SEQ}, {cfg.num_heads}, {hd}) bf16 "
        f"causal, bound {fa_bound:.4f} ms ({fa_by})")
    reading = {"layers": cfg.num_layers, "pack": k, "step0_gap": gap0,
               "all_gap": gap, "pool_step_wall_ms": wall_ms,
               "device_ms": fa_ms / max(fa_n, 1), "bound_ms": fa_bound,
               "remat_peaks_1_lane": {
                   name: [peaks[r][name][0] for r in (True, False)]
                   for name in ("held", "gradient", "pool step")}}
    if cfg.moe:
        experts = pool.params["blocks"]["moe"]
        casts = lambda: [experts[w][0, 0].to(torch.bfloat16)
                         for w in ("w_gate", "w_up", "w_down")]
        # each lane's forward and remat's recompute cast every layer's
        # experts once each
        cast_ms = 2 * k * cfg.num_layers * device_ms(casts, iters=3)
        log(f"[profile] {cfg.name}: f32 expert-weight casts to bf16 "
            f"{cast_ms:.2f} ms a pool step (forward and recompute, {k} "
            f"lanes x {cfg.num_layers} layers); share of the step's kernels "
            f"{cast_ms / busy:.3f}")
        reading["expert_cast_share"] = cast_ms / busy
    record[tag.replace("-", "_")] = reading
    del pool, batch, no_remat
    return model, bf, k


def profile_step(name: str, fn, args: tuple, *, n_params: float,
                 n_tokens: float, kind: str, shape: str) -> tuple:
    """[roofline] one step: its host-clock time (median of 3 warm calls),
    its counts on the card and on ``meta`` tensors of the same shapes
    (equal FLOPs, bytes and kernel leaves, or fail), its report's ``row()``
    beside the measured time, and ``IntensityProfile.from_step``. Returns
    (profile, reading)."""
    import torch
    from repro_torch.roofline import analysis, counting
    from repro_torch.roofline.analysis import IntensityProfile
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall_ms = float(np.median(walls[1:]))
    t0 = time.perf_counter()
    on_card = counting.count_step(fn, *args)
    count_s = time.perf_counter() - t0
    meta = counting.count_step(fn, *(_tree_to(a, "meta") for a in args))
    log(f"[roofline] {name}: counted on the card {on_card.flops:.6g} FLOPs, "
        f"{on_card.bytes:.6g} bytes (leaves {on_card.leaf_calls}, by tag "
        f"{on_card.bytes_by_tag}; {count_s:.2f} s to count), on meta "
        f"{meta.flops:.6g} FLOPs, {meta.bytes:.6g} bytes")
    if (on_card.flops, on_card.bytes, on_card.leaf_calls) != (
            meta.flops, meta.bytes, meta.leaf_calls):
        ops = sorted(set(on_card.bytes_by_op) | set(meta.bytes_by_op))
        log(f"[roofline] {name}: bytes by op, card != meta: " + ", ".join(
            f"{op} {on_card.bytes_by_op.get(op, 0)} != "
            f"{meta.bytes_by_op.get(op, 0)}" for op in ops
            if on_card.bytes_by_op.get(op) != meta.bytes_by_op.get(op)))
        raise AssertionError(f"[roofline] {name}: the card and meta count "
                             f"other work")
    top = sorted(on_card.bytes_by_op.items(), key=lambda kv: -kv[1])[:6]
    log(f"[roofline] {name}: most bytes by op: " + ", ".join(
        f"{op} {b / on_card.bytes:.1%}" for op, b in top))
    report = analysis.analyze_step(fn, *args, arch="h100", shape=shape,
                                   n_params=n_params, n_tokens=n_tokens,
                                   kind=kind)
    prof = IntensityProfile.from_step(fn, *args)
    if IntensityProfile.from_report(report) != prof:
        raise AssertionError(f"[roofline] {name}: from_step and from_report "
                             f"disagree")
    log(f"[roofline] {name}: row {json.dumps(report.row())}")
    log(f"[roofline] {name}: measured {wall_ms:.3f} ms a step (median of 3, "
        f"host clock, {min(walls[1:]):.3f}-{max(walls[1:]):.3f}); roofline "
        f"bound {1e3 * report.t_bound:.3f} ms ({report.bottleneck}), "
        f"{1e3 * report.t_bound / wall_ms:.3f} of it reached; {prof}")
    return prof, {"wall_ms": wall_ms, "flops": on_card.flops,
                  "bytes": on_card.bytes, "bound_ms": 1e3 * report.t_bound,
                  "memory_bound_frac": prof.memory_bound_frac,
                  "arithmetic_intensity": prof.arithmetic_intensity,
                  "count_s": count_s}


def roofline(record: dict, moe: tuple) -> None:
    """[roofline] ``profile_step`` of a 4-lane decode step of full-width,
    full-depth StableLM-2 (``decode_step`` with ``route_rows``, as
    ``BatchServer`` steps it) and of one masked pool step of [train-moe]'s
    lanes; the decode step must be the more memory-bound, and both
    profiles go through ``TriplesScheduler.submit(intensity_profile=...)``
    into admission."""
    import gc

    import torch
    from repro_torch import configs, optim
    from repro_torch.core import packing
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import ParallelCtx, build_model
    gc.collect()
    torch.cuda.empty_cache()
    profiles, readings = {}, {}
    cfg = configs.get("stablelm-1.6b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, ROOFLINE_PROMPT))).cuda()
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": toks},
                                 max_len=2 * ROOFLINE_PROMPT)
    step = {"tokens": toks[:, -1:],
            "pos": torch.full((4,), ROOFLINE_PROMPT, device="cuda")}

    def decode(p, b, c):
        with torch.inference_mode():
            return model.decode_step(p, b, c, route_rows=True)
    profiles["decode"], readings["decode"] = profile_step(
        f"{cfg.name} decode, 4 lanes", decode, (params, step, cache),
        n_params=cfg.param_count(), n_tokens=4, kind="decode",
        shape=f"4 lanes at position {ROOFLINE_PROMPT}")
    del params, cache, step

    # [train-moe]'s model with its attention path named: "kernel" is what
    # it takes on the card by default, and the meta count must take it too
    # (with none named, a meta tensor would pick the CPU's "chunked")
    cfg_moe, bf, k = moe[0].cfg, moe[1], moe[2]
    moe_model = build_model(cfg_moe, ParallelCtx(attn_impl="kernel"))
    opt = optim.adamw(weight_decay=0.0)
    pool, batch = lm_pool(moe_model, k, bf, opt)
    pool_step = packing.masked_pool_step(make_train_step(moe_model, opt))
    mask = np.array(pool.active)

    def train(params, opt_state, batch, hparams):
        return pool_step(params, opt_state, batch, hparams, mask)
    mcfg = moe_model.cfg
    profiles["train"], readings["train"] = profile_step(
        f"{mcfg.name} x{mcfg.num_layers} pool step, {k} lanes", train,
        (pool.params, pool.opt_state, batch, pool.hparams),
        n_params=mcfg.param_count(), n_tokens=k * TRAIN_LM_BATCH *
        TRAIN_LM_SEQ, kind="train",
        shape=f"{k} lanes x {TRAIN_LM_BATCH} x {TRAIN_LM_SEQ}")
    del pool, batch
    if not (profiles["decode"].memory_bound_frac
            > profiles["train"].memory_bound_frac):
        raise AssertionError("[roofline] the decode step is not more "
                             "memory-bound than the training step")
    recorded = schedule_profiles(profiles,
                                 float(torch.cuda.mem_get_info()[1]))
    log(f"[roofline] admission recorded at first dispatch: " + ", ".join(
        f"kind:{kind} {v}" for kind, v in recorded.items()))
    if recorded != {kind: p.interference for kind, p in profiles.items()}:
        raise AssertionError(f"[roofline] admission recorded {recorded}")
    record["roofline"] = readings


# ---------------------------------------------------------------------------
# phase 8: the policy and durability layer on a parametric study
# ---------------------------------------------------------------------------

def study_setup(cfg) -> dict:
    """The paper's LLMapReduce use: score STUDY_ITEMS prompts of STUDY_SEQ
    tokens (numpy seed 0) with one model (torch seed 0), each item's
    result its mean token NLL, ``Model.loss(params, batch)[0]``. One set of
    parameters serves the four phases; ``timing_items`` (the gated items
    first) time the throughput."""
    import torch
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (STUDY_TIMING_ITEMS, 1, STUDY_SEQ + 1),
        dtype=np.int64)).cuda()
    timing_items = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]

    def loss(p, batch):
        with torch.no_grad():
            return model.loss(p, batch)[0]
    log(f"[mapreduce] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.param_count() / 1e9:.3f} B params "
        f"{cfg.param_dtype}, {cfg.compute_dtype} compute; {STUDY_ITEMS} "
        f"prompts of {STUDY_SEQ} tokens ({STUDY_TIMING_ITEMS} to time); init "
        f"{time.perf_counter() - t0:.1f} s")
    return {"cfg": cfg, "model": model, "params": params,
            "items": timing_items[:STUDY_ITEMS], "timing_items": timing_items,
            "loss": loss, "score": lambda batch: loss(params, batch),
            "hbm": float(torch.cuda.mem_get_info(model.device)[1])}


def b3_launches(phase: str, want: int) -> int:
    """B3's launches since the last ``reset_launches``: ``want`` of them,
    every one on the tensor-core (wgmma) body."""
    from repro_torch.kernels import flash_attention as fa
    got = fa.flash_attention_cuda.launches
    by_body = dict(fa.flash_attention_cuda.launches_by_body)
    log(f"[{phase}] flash_attention launches {got} (by body {by_body}), "
        f"want {want}")
    if got != want or by_body.get("wgmma") != got:
        raise AssertionError(f"[{phase}] flash_attention launched {got} "
                             f"times ({by_body}), want {want} on wgmma")
    return got


def study_mapreduce(record: dict, study: dict) -> list:
    """``llmapreduce`` packed (the items as lanes of one refilled pool,
    ``trip.total_slots`` of them, B3 once a layer a pool step with the
    lanes folded into its batch) and slotted (one item at a time through
    ``TriplesScheduler``), a profile of each, then each path's throughput
    on the longer timing study. Returns the slotted per-item losses."""
    import functools
    import operator
    import torch
    from repro_torch.core.mapreduce import llmapreduce
    from repro_torch.core.triples import Triples
    cfg, items, score = study["cfg"], study["items"], study["score"]
    n, L = len(items), cfg.num_layers
    trip = Triples(*STUDY_TRIPLES)
    score(items[0])                     # warm: not part of either timing
    torch.cuda.synchronize()
    steps = -(-n // trip.total_slots)

    reset_launches()                    # the main path
    t0 = time.perf_counter()
    lanes, stats = llmapreduce(score, items, trip=trip, mode="packed",
                               return_stats=True)
    packed = [float(v) for v in lanes]
    packed_s = time.perf_counter() - t0
    record["launches_mapreduce_packed"] = b3_launches("mapreduce",
                                                      steps * L)
    log(f"[mapreduce] packed, {trip}: wall {packed_s:.3f} s, "
        f"{n / packed_s:.2f} items/s; lane_steps {stats.lane_steps}, "
        f"global_steps {stats.global_steps}, n_traces {stats.n_traces}")
    if (stats.lane_steps, stats.global_steps, stats.n_traces) != (
            n, steps, 1):
        raise AssertionError(f"packed pool counters {stats}")

    reset_launches()
    t0 = time.perf_counter()
    slotted = llmapreduce(lambda b: float(score(b)), items, trip=trip,
                          mode="slotted")
    slotted_s = time.perf_counter() - t0
    record["launches_mapreduce_slotted"] = b3_launches("mapreduce", n * L)
    gap = max(abs(a - b) / abs(b) for a, b in zip(packed, slotted))
    spread = (max(slotted) - min(slotted)) / min(slotted)
    nearest = [min(range(n), key=lambda j: abs(p - slotted[j]))
               for p in packed]
    log(f"[mapreduce] slotted: wall {slotted_s:.3f} s, "
        f"{n / slotted_s:.2f} items/s; per-item losses "
        f"{', '.join(f'{v:.4f}' for v in slotted)} (spread {spread:.3g} "
        f"relative); packed vs slotted max relative gap {gap:.3g} (rtol "
        f"{STUDY_LOSS_RTOL}), each packed loss nearest its own item: "
        f"{nearest == list(range(n))}")
    if not (np.isfinite(packed).all() and np.isfinite(slotted).all()
            and gap <= STUDY_LOSS_RTOL and nearest == list(range(n))):
        raise AssertionError(f"packed vs slotted losses: gap {gap}, "
                             f"nearest slotted items {nearest}")

    total = float(llmapreduce(score, items, trip=trip,
                              reduce_fn=operator.add))
    want = float(functools.reduce(operator.add, lanes))
    log(f"[mapreduce] reduce_fn=operator.add, packed: {total!r}; the fold "
        f"of the packed list: {want!r}")
    if not abs(total - want) <= STUDY_LOSS_RTOL * abs(want):
        raise AssertionError("reduce_fn: the sum is not the list's sum")
    record["mapreduce"] = {"items": n, "triples": list(STUDY_TRIPLES),
                           "packed_s": packed_s, "slotted_s": slotted_s,
                           "loss_gap": gap, "loss_spread": spread}
    # each whole path on the gated items: wall (median of 3), kernels,
    # idle share
    paths = {"packed": lambda its: llmapreduce(score, its, trip=trip),
             "slotted": lambda its: llmapreduce(
                 lambda b: float(score(b)), its, trip=trip, mode="slotted")}
    for (wall_ms, by_name), path in zip(profile_calls(
            [(f"llmapreduce {path}, {n} items", lambda f=f: f(items))
             for path, f in paths.items()]), paths):
        busy = log_by_kind(by_name)
        record["mapreduce"][path] = {
            "wall_ms": wall_ms, "kernel_ms": busy, "idle": 1 - busy / wall_ms}
    # throughput on the timing study, the two paths taking turns so that
    # both see the same host: three rounds, unprofiled
    timing = study["timing_items"]
    m = len(timing)
    walls = {path: [] for path in paths}
    for _ in range(3):
        for path, f in paths.items():
            t0 = time.perf_counter()
            f(timing)
            torch.cuda.synchronize()
            walls[path].append(time.perf_counter() - t0)
    for path, w in walls.items():
        record["mapreduce"][path].update(
            timing_items=m, timing_walls_s=w,
            items_per_s=m / float(np.median(w)))
    p, q = (float(np.median(walls[k])) for k in paths)
    ratios = [b / a for a, b in zip(walls["packed"], walls["slotted"])]
    record["mapreduce"]["throughput_ratio"] = q / p
    log(f"[mapreduce] {m} items, three rounds taking turns: packed walls "
        f"{', '.join(f'{w:.3f}' for w in walls['packed'])} s "
        f"({m / p:.2f} items/s, median), slotted "
        f"{', '.join(f'{w:.3f}' for w in walls['slotted'])} s "
        f"({m / q:.2f} items/s); packed/slotted {q / p:.2f}x (by round "
        f"{', '.join(f'{r:.2f}' for r in ratios)})")
    return slotted


def study_sched(record: dict, study: dict, slotted: list) -> None:
    """``TriplesScheduler`` under ``Tenancy`` on one node of one card:
    tasks score one item each at batch 1; the lane footprint is measured
    (``monitor.memory_per_lane``); tenant A's gang of every item is
    admitted, a gang whose lane outgrows the card is rejected, and a gang
    of tenant B preempts A (cursors through the ``Checkpointer``), after
    which A resumes and runs only the tasks it had not completed."""
    import tempfile
    from repro_torch.checkpoint import load_extra
    from repro_torch.core import monitor, tenancy
    from repro_torch.core.scheduler import (ClusterState, Task, Tenancy,
                                            TriplesScheduler)
    from repro_torch.core.triples import NodeSpec, Triples
    cfg, items, score = study["cfg"], study["items"], study["score"]
    n, L = len(items), cfg.num_layers
    bpl = monitor.memory_per_lane(study["loss"], study["params"], items[0])
    node = NodeSpec(chips_per_node=1, hbm_per_chip=study["hbm"])
    log(f"[sched] bytes_per_lane {bpl / 1e9:.3f} GB (memory_per_lane of the "
        f"scoring step), node: 1 chip of {study['hbm'] / 1e9:.2f} GB")
    executed = []

    def tasks(tag, idx):
        return [Task(id=k, fn=lambda ctx, tag=tag, i=i: executed.append(
            (tag, i)) or float(score(items[i]))) for k, i in enumerate(idx)]
    b_items = [0, 1]
    with tempfile.TemporaryDirectory() as ck:
        gauges = monitor.TenantGauges()
        sched = TriplesScheduler(
            ClusterState(1, node), checkpoint_dir=ck,
            tenancy=Tenancy.create(
                node_spec=node, gauges=gauges,
                preemption=tenancy.PreemptionPolicy(wait_threshold=2)))
        reset_launches()
        t0 = time.perf_counter()
        a = sched.submit("A", tasks("A", range(n)), Triples(1, 2, 1),
                         bytes_per_lane=bpl)
        big = sched.submit("C", tasks("C", [0]), Triples(1, 1, 1),
                           bytes_per_lane=2 * study["hbm"])
        b = sched.submit("B", tasks("B", b_items), Triples(1, 1, 1),
                         bytes_per_lane=bpl)
        done = sched.run_queued()
        wall = time.perf_counter() - t0
        launches = b3_launches("sched", (n + len(b_items)) * L)
        gang_dir = os.path.join(ck, f"gang_{a.id}")
        extra, step = load_extra(gang_dir)
    kinds = [e.kind for e in sched.events]
    log(f"[sched] wall {wall:.3f} s; A {a.state}, B {b.state}, C "
        f"{big.state} ({big.reject_reason}); events: preempt "
        f"{kinds.count('preempt')}, resume {kinds.count('resume')}; A's "
        f"cursor at round {step}: {len(extra['completed'])} completed, "
        f"{len(extra['remaining'])} remaining")
    for line in gauges.table().splitlines():
        log(f"[sched] {line}")
    if big.state != "rejected" or a.id not in done or b.id not in done:
        raise AssertionError("admission: the oversized gang was not "
                             "rejected or a gang did not finish")
    if done[a.id].failed or done[b.id].failed or \
            done[a.id].preemptions != 1 or kinds.count("preempt") != 1:
        raise AssertionError(f"A: failed {done[a.id].failed}, "
                             f"preemptions {done[a.id].preemptions}")
    if not (extra["gang_checkpoint"] and extra["user"] == "A"
            and extra["completed"] and extra["remaining"]):
        raise AssertionError(f"gang cursor file: {extra}")
    if sorted(executed) != sorted([("A", i) for i in range(n)]
                                  + [("B", i) for i in b_items]):
        raise AssertionError(f"tasks executed other than once: {executed}")
    got = [done[a.id].results[k] for k in range(n)]
    if got != slotted or [done[b.id].results[k] for k in range(
            len(b_items))] != [slotted[i] for i in b_items]:
        raise AssertionError("scheduled losses are not bit-equal to the "
                             "slotted pass")
    record["launches_sched"] = launches
    record["sched"] = {"bytes_per_lane": bpl, "wall_s": wall,
                       "preemptions": 1, "cursor_round": step}


def study_controlplane(record: dict, study: dict, slotted: list) -> None:
    """A ``ControlPlane`` with the scoring task registered by name, run
    once uncrashed, then crashed at a middle record boundary and restarted
    (``ControlPlane(...).start()`` is recovery): the recovered results
    equal the uncrashed ones, the two decision logs do not differ, and no
    task ran more than once but the one in flight at the crash."""
    import tempfile
    from repro_torch.core import controlplane as cp
    from repro_torch.core import eventlog
    from repro_torch.core.faults import CrashHook, CrashInjected
    from repro_torch.core.triples import NodeSpec, Triples
    cfg, items, score = study["cfg"], study["items"], study["score"]
    n, L = len(items), cfg.num_layers
    node = NodeSpec(chips_per_node=1, hbm_per_chip=study["hbm"])
    runs = []

    def score_item(ctx, i):
        runs.append(i)
        return float(score(items[i]))
    cp.register_task("study_score", score_item)

    def drive(plane):
        job = plane.submit("A", "study_score", job_key="study",
                           trip=Triples(1, 2, 1), payloads=list(range(n)))
        plane.run()
        return job

    with tempfile.TemporaryDirectory() as tmp:
        clean, crashed = os.path.join(tmp, "clean"), os.path.join(tmp, "crash")
        reset_launches()
        t0 = time.perf_counter()
        plane = cp.ControlPlane(clean, n_nodes=1, node_spec=node).start()
        want = dict(drive(plane).result.results)
        digest = plane.state_digest()
        plane.close()
        clean_s = time.perf_counter() - t0
        b3_launches("controlplane", n * L)
        records = eventlog.EventLog(clean).replay()
        k = len(records) // 2
        runs.clear()
        reset_launches()
        t0 = time.perf_counter()
        plane = cp.ControlPlane(crashed, n_nodes=1, node_spec=node,
                                crash_hook=CrashHook(after=k))
        try:
            plane.start()
            drive(plane)
            raise AssertionError(f"no crash at record boundary {k}")
        except CrashInjected:
            pass
        plane.close()
        first = len(runs)
        plane = cp.ControlPlane(crashed, n_nodes=1, node_spec=node).start()
        got = dict(drive(plane).result.results)
        recovered_digest = plane.state_digest()
        plane.close()
        crash_s = time.perf_counter() - t0
        launches = b3_launches("controlplane", len(runs) * L)
        diff = eventlog.diff_decision_logs(
            eventlog.decision_view(records),
            eventlog.decision_view(eventlog.EventLog(crashed).replay()))
    log(f"[controlplane] uncrashed: {len(records)} records, {clean_s:.3f} s;"
        f" crash at record boundary {k}: {first} task runs before it, "
        f"{len(runs) - first} after recovery ({len(runs)} in all, at most "
        f"{n + 1}), {crash_s:.3f} s; decision-log diff rows {len(diff)}")
    if got != want or [want[i] for i in range(n)] != slotted:
        raise AssertionError("recovered results differ from the uncrashed "
                             "run's or from the slotted pass")
    if diff or recovered_digest != digest or len(runs) > n + 1:
        raise AssertionError(f"recovery: diff {diff}, {len(runs)} runs")
    record["launches_controlplane"] = launches
    record["controlplane"] = {"records": len(records), "crash_at": k,
                              "task_runs": len(runs)}


def study_replay(record: dict) -> None:
    """The port's ``compare_modes`` over the six committed traces against
    the last entry of ``BENCH_HISTORY.json``: every field, exactly."""
    from repro_torch.core import simulate, traces
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    got = replay_quality(simulate, traces, root / "benchmarks" / "traces")
    wall = time.perf_counter() - t0
    with open(root / "BENCH_HISTORY.json") as f:
        committed = json.load(f)["entries"][-1]["quality"]
    drift = diff_quality(committed, got)
    n_fields = sum(len(m) for t in got.values() for m in t.values())
    log(f"[replay] {len(got)} traces x {len(next(iter(got.values())))} "
        f"modes, {n_fields} fields against BENCH_HISTORY.json's last entry "
        f"(Python {sys.version.split()[0]}): {len(drift)} drift rows, "
        f"{wall:.2f} s")
    if drift or sorted(got) != sorted(committed):
        raise AssertionError(f"replay drift: {drift[:5]}")
    record["replay"] = {"fields": n_fields, "drift_rows": 0, "wall_s": wall}


def policy_phases(record: dict) -> None:
    """Phase 8 on full-width, full-depth StableLM-2 1.6B. Adds B3's
    launches on each phase to ``record``."""
    from repro_torch import configs
    study = study_setup(configs.get("stablelm-1.6b"))
    slotted = study_mapreduce(record, study)
    study_sched(record, study, slotted)
    study_controlplane(record, study, slotted)
    study_replay(record)


# ---------------------------------------------------------------------------
# [replay]: the committed traces against BENCH_HISTORY.json
# ---------------------------------------------------------------------------

def replay_metrics(r) -> dict:
    """One mode's quality row, as the history records it (the fields of
    ``benchmarks/bench_trace_replay.py::_metrics``)."""
    return {
        "utilization": r.node_util,
        "effective_util": r.effective_util,
        "p50_wait": r.p50_wait(),
        "p99_wait": r.p99_wait(),
        "mean_wait": r.mean_wait(),
        "makespan": r.makespan,
        "throughput": r.throughput,
        "completed": len(r.stats),
        "rejected": len(r.rejected),
        "events": r.events,
        "lane_backfills": r.lane_backfills,
        "preemptions": r.preemptions,
        "repacks": r.repacks,
        "spatial_placements": r.spatial_placements,
    }


def replay_quality(S, TR, traces_dir, names=None) -> dict:
    """{trace: {mode: metrics}} of ``S.compare_modes`` over the committed
    trace files; ``S`` and ``TR`` are a package's ``simulate`` and
    ``traces`` modules (the tests pass the reference's too)."""
    quality = {}
    for name in sorted(TR.CANONICAL if names is None else names):
        header, jobs = TR.load_jsonl(TR.trace_path(str(traces_dir), name))
        cfg = TR.replay_config_from(header)
        reports = S.compare_modes(jobs, cfg.n_nodes, **TR.replay_kwargs(cfg))
        quality[name] = {mode: replay_metrics(r)
                         for mode, r in reports.items()}
    return quality


def diff_quality(old: dict, new: dict) -> list:
    """Drift rows between two quality blobs, compared exactly (``!=`` on
    the doubles), a trace or mode present in one only included (the rule
    of ``benchmarks/bench_trace_replay.py::diff_quality``)."""
    out = []
    side = lambda in_old: "committed" if in_old else "current"
    for trace in sorted(set(old) | set(new)):
        if trace not in old or trace not in new:
            out.append(f"{trace}: only in {side(trace in old)}")
            continue
        for mode in sorted(set(old[trace]) | set(new[trace])):
            if mode not in old[trace] or mode not in new[trace]:
                out.append(f"{trace}/{mode}: only in "
                           f"{side(mode in old[trace])}")
                continue
            om, nm = old[trace][mode], new[trace][mode]
            for k in sorted(set(om) | set(nm)):
                if om.get(k) != nm.get(k):
                    out.append(f"{trace}/{mode}/{k}: committed="
                               f"{om.get(k)!r} current={nm.get(k)!r}")
    return out


def schedule_profiles(profiles: dict, hbm: float) -> dict:
    """Each ``IntensityProfile`` of ``profiles`` (by kind) submitted to a
    ``TriplesScheduler`` under ``Tenancy`` on one node of one chip of
    ``hbm`` bytes, as a gang of one no-op task owned by a user of the
    kind's name, with ``submit(kind=..., intensity_profile=...)``; runs
    the queue and returns what admission recorded under ``kind:<kind>``
    at each gang's first dispatch."""
    from repro_torch.core.scheduler import (ClusterState, Task, Tenancy,
                                            TriplesScheduler)
    from repro_torch.core.triples import NodeSpec, Triples
    node = NodeSpec(chips_per_node=1, hbm_per_chip=hbm)
    sched = TriplesScheduler(ClusterState(1, node),
                             tenancy=Tenancy.create(node_spec=node))
    jobs = [sched.submit(kind, [Task(id=0, fn=lambda ctx: 0.0)],
                         Triples(1, 1, 1), kind=kind, intensity_profile=prof)
            for kind, prof in profiles.items()]
    done = sched.run_queued()
    if sorted(done) != sorted(j.id for j in jobs) or any(
            done[j.id].failed for j in jobs):
        raise AssertionError("a profiled gang did not run")
    adm = sched.tenancy.admission
    return {kind: adm.measured_intensity(f"kind:{kind}") for kind in profiles}


# ---------------------------------------------------------------------------
# phase 9: the distributed layer ([dist-ep], [dist-ssm], [dist-train],
# [dryrun])
# ---------------------------------------------------------------------------

# [dist-train]: full-width StableLM-2 1.6B at [train-lm]'s depth and one
# lane's batch, DIST_TRAIN_STEPS AdamW steps sharded (fsdp) on a (1, 1)
# mesh against the same steps unsharded; if they are not bit-equal, the
# first differing op is named and they are held within DIST_TRAIN_RTOL.
# The mesh step's step-0 gradients are also held against the unsharded
# route by torch.func (the one make_train_step takes for plain params, and
# the lane pool's), each leaf within DIST_TRAIN_RTOL of its largest entry,
# with the compute in f32, as the 8-rank CPU test holds them, and bit-equal
# (DIST_TRAIN_BF16_RTOL) in the train path's bf16 compute, as
# tests/test_torch_train.py holds them on the CPU: SiLU has one backward on
# both routes (models.layers.silu)
DIST_TRAIN_STEPS = 3
DIST_TRAIN_RTOL = 1e-5
DIST_TRAIN_BF16_RTOL = 0.0
DIST_TRAIN_LR = 1e-4
# [dist-ssm] and [dist-ep]'s decode: greedy decode steps after the prefill,
# the tokens taken from the unsharded route so that both routes see the
# same inputs; the sharded logits and cache are held bit-equal
# (DIST_DECODE_ATOL) to the unsharded ones: on one rank the mesh routes run
# the same kernels on the same local tensors
DIST_DECODE_STEPS = 8
DIST_DECODE_ATOL = 0.0
# [dryrun]: full-size production cells, each counted on meta in a fake
# process group by its own ``python -m repro_torch.launch.dryrun`` child,
# all started together
DRYRUN_CELLS = (("llama3-405b", "train_4k", "single"),
                ("arctic-480b", "train_4k", "multi"),
                ("deepseek-moe-16b", "decode_32k", "single"),
                ("zamba2-7b", "long_500k", "single"),
                ("qwen2-vl-7b", "train_4k", "single"),
                ("zamba2-7b", "train_4k", "single"),
                ("llama3-405b", "prefill_32k", "single"),
                ("zamba2-7b", "decode_32k", "single"),
                ("mamba2-130m", "decode_32k", "multi"),
                ("arctic-480b", "decode_32k", "multi"))
DRYRUN_OUT = Path(__file__).resolve().parent / "build" / "dryrun"
# the reference's (temp_gb_dev, TFLOP a device, coll_gb_dev) for the same
# cells: XLA's temp_size_in_bytes of its CPU compile (which leaves out the
# step's outputs, as the port's temp_gb_dev does), hlo_gflops_dev / 1000
# and the operand bytes of its collectives (analyze_hlo's
# collective_operand_bytes), from `DRYRUN_DEVICES=256 PYTHONPATH=src python
# -m repro.launch.dryrun --arch A --shape S --mesh single` (512 and --mesh
# multi for the multi-pod cells) with jax 0.9.0; kept here because this
# script imports nothing of the reference. Each cell is held to twice the
# reference's temp and 1.25 times its TFLOP (C18, C24, C25), and the cells
# of DRYRUN_COLL_GATED to twice its collectives (C26, C27); the others
# print their ratio
DRYRUN_REFERENCE = {
    ("llama3-405b", "train_4k", "single"): (80.929361952, 12935.71994104627,
                                            4799.071506592),
    ("arctic-480b", "train_4k", "multi"): (24.3084756, 321.39240275968,
                                           1073.068131056),
    ("deepseek-moe-16b", "decode_32k", "single"): (10.134694672,
                                                   0.020482883584,
                                                   0.316707176),
    ("zamba2-7b", "long_500k", "single"): (0.243398616, 0.000450273408,
                                           0.035924224),
    ("qwen2-vl-7b", "train_4k", "single"): (14.764463768, 241.94624520192,
                                            1105.977431704),
    ("zamba2-7b", "train_4k", "single"): (28.538585792, 344.642713288704,
                                          562.24446678),
    ("llama3-405b", "prefill_32k", "single"): (18.414044048,
                                               4398.596792254464,
                                               1205.53210676),
    ("zamba2-7b", "decode_32k", "single"): (9.655382648, 0.012191805952,
                                            0.153807968),
    ("mamba2-130m", "decode_32k", "multi"): (0.01626928, 6.6932736e-05,
                                             0.002643476),
    ("arctic-480b", "decode_32k", "multi"): (10.681343712, 0.48106569728,
                                             3.925853876)}
DRYRUN_TEMP_RATIO = 2.0
DRYRUN_TFLOP_RATIO = 1.25
DRYRUN_COLL_RATIO = 2.0
DRYRUN_COLL_GATED = {("deepseek-moe-16b", "decode_32k", "single"),
                     ("zamba2-7b", "decode_32k", "single"),
                     ("mamba2-130m", "decode_32k", "multi"),
                     ("arctic-480b", "decode_32k", "multi")}


def dist_ep_shape(prompt_len: int):
    from repro_torch.configs.base import ShapeSpec
    return ShapeSpec("dist_ep", prompt_len, 1, "prefill")


def dist_train_shape():
    from repro_torch.configs.base import ShapeSpec
    return ShapeSpec("dist_train", TRAIN_LM_SEQ, TRAIN_LM_BATCH, "train")


def dist_ssm_shapes(prompt_len: int):
    """[dist-ssm]'s prefill of one prompt and a decode step of one row."""
    from repro_torch.configs.base import ShapeSpec
    return (ShapeSpec("dist_ssm", prompt_len, 1, "prefill"),
            ShapeSpec("dist_ssm_decode", prompt_len + DIST_DECODE_STEPS, 1,
                      "decode"))


def meta_twins(ep_prompt_len: int, ssm_prompt_len: int) -> None:
    """Run in a child process (a ``"fake"`` group cannot share a process
    with the NCCL one): [dist-ep]'s EP prefill, [dist-train]'s sharded
    step, and [dist-ssm]'s prefill and one decode step counted on meta
    tensors in a fake group of one rank on a (1, 1) mesh. Prints one JSON
    line: each one's collectives (kind, result bytes, group size),
    argument bytes and the whole peak of the storages it makes
    (``live_peak_bytes``: its outputs included, what the card's allocator
    holds above the arguments)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    out = {}
    ssm_prefill, ssm_decode = dist_ssm_shapes(ssm_prompt_len)
    with dryrun.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        for name, arch, shape, over in (
                ("ep", "deepseek-moe-16b", dist_ep_shape(ep_prompt_len),
                 dict(num_layers=MOE_LAYERS)),
                ("train", "stablelm-1.6b", dist_train_shape(),
                 dict(num_layers=TRAIN_LM_LAYERS)),
                ("ssm", "mamba2-130m", ssm_prefill, None),
                ("ssm_decode", "mamba2-130m", ssm_decode, None)):
            c = dryrun.count_cell(arch, shape, mesh, overrides=over)[0]
            out[name] = {"collectives": [[op.kind, op.result_bytes,
                                          op.group_size]
                                         for op in c.collectives],
                         "arg_bytes": c.arg_bytes,
                         "live_peak_bytes": c.live_peak_bytes,
                         "flops": c.flops}
    print(json.dumps(out))


def start_child(label: str, args: list):
    """(label, process, start time) of ``python args...`` started now from
    the checkout's root; ``finish_children`` collects it."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return (label, subprocess.Popen(
        [sys.executable, *args], cwd=str(Path(__file__).resolve().parent),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True), time.perf_counter())


def start_dryrun_cells() -> list:
    return [start_child(f"{arch} × {shape} × {mesh}", [
        "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
        "--mesh", mesh, "--out", str(DRYRUN_OUT)])
        for arch, shape, mesh in DRYRUN_CELLS]


def finish_children(kids: list, timeout: float = 900) -> dict:
    """Wait for every child; returns {label: (exit code, output, s)}. A
    child still running at ``timeout`` is killed (and fails its phase)."""
    out = {}
    for label, p, t0 in kids:
        try:
            text, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        out[label] = (p.returncode, text, time.perf_counter() - t0)
    return out


@contextlib.contextmanager
def nccl_world():
    """A NCCL default group of one rank on this card (NCCL takes no two
    ranks on one device); a failure to make it fails the phase."""
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _collectives(counts) -> list:
    return [[op.kind, op.result_bytes, op.group_size]
            for op in counts.collectives]


def decode_run(model, params, place, tok, max_len: int, toks=None):
    """``model``'s prefill of ``tok`` (1, S), then ``DIST_DECODE_STEPS``
    decode steps of one row routed row by row, as the server decodes; each
    batch through ``place`` (its DTensors on a mesh). The steps feed
    ``toks`` or, where none are given, each step's greedy token. Returns
    (logits of the prefill and of each step, the tokens fed, a copy of
    the cache before each step, the final cache)."""
    import torch
    from repro_torch.core import packing
    S = tok.shape[1]
    logits, cache = model.prefill(params, place({"tokens": tok}), max_len)
    outs, fed, before = [logits], [], []
    for i in range(DIST_DECODE_STEPS):
        t = toks[i] if toks is not None else int(
            _whole(logits).argmax(-1)[0])
        fed.append(t)
        before.append(packing.tree_map(lambda x: x.clone(), cache))
        step = {"tokens": torch.full((1, 1), t, device="cuda"),
                "pos": torch.full((1,), S + i, device="cuda")}
        logits, cache = model.decode_step(params, place(step), cache,
                                          route_rows=True)
        outs.append(logits)
    return outs, fed, before, cache


def _whole(t):
    """A DTensor's whole value; a plain tensor as it is."""
    return t.full_tensor() if type(t).__name__ == "DTensor" else t


def sharded_decode(tag: str, plain, params, model, dparams, mesh, tok,
                   sharded_run=contextlib.nullcontext) -> float:
    """``decode_run`` of ``plain`` on ``params`` (unsharded), then of
    ``model`` on ``dparams`` (DTensors on the one-rank ``mesh``) fed the
    unsharded run's tokens, inside ``sharded_run()``: each logit row and
    every cache leaf held within ``DIST_DECODE_ATOL`` (bit-equal) of the
    unsharded ones; where they are not bit-equal, the first op of the
    first differing call (0 the prefill) whose result the sharded route
    does not reproduce is named (``op_trace``, ``first_difference``).
    Returns the largest difference."""
    import torch
    from repro_torch.core import packing
    from repro_torch.distributed import sharding
    S = tok.shape[1]
    max_len = S + DIST_DECODE_STEPS

    def place(b):
        return sharding.distribute_local(
            b, mesh, sharding.batch_shardings(mesh, b, 1))
    want = decode_run(plain, params, lambda b: b, tok, max_len)
    with sharded_run():
        got = decode_run(model, dparams, place, tok, max_len, toks=want[1])
    diffs = [(_whole(g) - w).abs().max().item()
             for g, w in zip(got[0], want[0])]
    leaves = [(_whole(g) - w).abs().max().item() for g, w in zip(
        packing.tree_leaves(got[3]), packing.tree_leaves(want[3]))]
    worst = max(diffs + leaves)
    log(f"[{tag}] prefill + {DIST_DECODE_STEPS} decode steps: logits "
        f"bit-equal to ParallelCtx()'s {all(d == 0 for d in diffs)} "
        f"(largest difference by call {[f'{d:.3g}' for d in diffs]}); "
        f"final cache bit-equal {all(d == 0 for d in leaves)} ({len(leaves)}"
        f" leaves, largest difference {max(leaves):.3g}); tokens fed "
        f"{want[1]}")
    if worst > 0:
        call = next((i for i, d in enumerate(diffs) if d > 0), 0)
        if call == 0:
            traces = (op_trace(lambda: plain.prefill(
                          params, {"tokens": tok}, max_len)),
                      op_trace(lambda: model.prefill(
                          dparams, place({"tokens": tok}), max_len)))
        else:
            step = {"tokens": torch.full((1, 1), want[1][call - 1],
                                         device="cuda"),
                    "pos": torch.full((1,), S + call - 1, device="cuda")}
            traces = (op_trace(lambda: plain.decode_step(
                          params, step, want[2][call - 1], route_rows=True)),
                      op_trace(lambda: model.decode_step(
                          dparams, place(step), got[2][call - 1],
                          route_rows=True)))
        log(f"[{tag}] first op of call {call} (0 the prefill) whose result "
            f"the sharded route does not reproduce: "
            f"{first_difference(*traces)}")
    if not worst <= DIST_DECODE_ATOL:
        raise AssertionError(f"[{tag}] the sharded route differs from "
                             f"ParallelCtx()'s by {worst:.3g} > "
                             f"{DIST_DECODE_ATOL}")
    return worst


def dist_ssm(rec_b4: dict, mesh, twins: dict) -> None:
    """[dist-ssm]: full-width, full-depth mamba2-130m, the prefill of
    [serve-ssm]'s longest request and ``DIST_DECODE_STEPS`` decode steps
    with params and cache as DTensors on the (1, 1) mesh: the prefill's
    scan is B4 under ``local_map`` (``ssm._scan_on_mesh``) and each step's
    state update runs under ``local_map`` (``ssm._state_step_on_mesh``).
    Logits and the final cache against the same run under
    ``ParallelCtx()`` (``sharded_decode``); every B4 call held to its
    plain version on its served inputs, B4 launched once a layer, all on
    the bf16 body; the card's peak above the resident tensors beside the
    meta twins' arguments and peaks."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ssd_scan as sd
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ParallelCtx
    cfg = configs.get("mamba2-130m")
    r0 = max(ssm_requests(cfg.vocab_size), key=lambda r: len(r.prompt))
    S = len(r0.prompt)
    tok = torch.as_tensor(r0.prompt, device="cuda")[None]
    plain = Model(cfg, device="cuda")
    params = plain.init(torch.Generator(device="cuda").manual_seed(0))
    sharded = Model(cfg, ParallelCtx(mesh=mesh), device="cuda")
    dparams = sharding.distribute_local(
        params, mesh, sharding.param_shardings(mesh, params))
    seen: dict = {}

    @contextlib.contextmanager
    def measured():
        """The sharded run: every count set to 0 just before it, each B4
        call held to its plain version, the peak above what is resident."""
        gc_collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with served_kernel_checks("dist-ssm") as checks:
            reset_launches()
            yield
            torch.cuda.synchronize()
            seen.update(checks, n=sd.ssd_scan_cuda.launches,
                        by_body=dict(sd.ssd_scan_cuda.launches_by_body),
                        peak=torch.cuda.max_memory_allocated() - base)
    with torch.no_grad():
        worst = sharded_decode("dist-ssm", plain, params, sharded, dparams,
                               mesh, tok, measured)
    n, by_body, peak = seen["n"], seen["by_body"], seen["peak"]
    log(f"[dist-ssm] {cfg.name} {cfg.num_layers} layers, prompt {S}: B4 "
        f"{n} launches (by body {by_body}), want {cfg.num_layers} on bf16, "
        f"each within its limits of the plain version on its served inputs "
        f"(max abs err y {max(seen['b4']):.3g}, final state "
        f"{max(seen['b4_state']):.3g} of its allowance)")
    if n != cfg.num_layers or by_body.get("bf16") != n:
        raise AssertionError(f"[dist-ssm] ssd_scan launched {n} times "
                             f"({by_body}), want {cfg.num_layers} on bf16")
    tw = {k: twins[k] for k in ("ssm", "ssm_decode")}
    whole = torch.cuda.max_memory_allocated() / 1e9
    log(f"[dist-ssm] the card's peak above the resident tensors over the "
        f"sharded prefill and {DIST_DECODE_STEPS} steps {peak / 1e9:.4g} GB "
        f"(the card's whole peak {whole:.4g} GB, both routes' params and "
        f"caches resident); meta twins, "
        f"arg + peak: prefill {tw['ssm']['arg_bytes'] / 1e9:.4g} + "
        f"{tw['ssm']['live_peak_bytes'] / 1e9:.4g} GB, decode step "
        f"{tw['ssm_decode']['arg_bytes'] / 1e9:.4g} + "
        f"{tw['ssm_decode']['live_peak_bytes'] / 1e9:.4g} GB")
    rec_b4["launches_dist_ssm"] = n
    rec_b4["dist_ssm"] = {"prompt": S, "decode_steps": DIST_DECODE_STEPS,
                          "max_abs_diff": worst, "peak_gb": peak / 1e9}
    del params, dparams, plain, sharded


def dist_ep(record: dict, mesh, twins: dict) -> None:
    """[dist-ep]: full-width DeepSeekMoE-16B at [serve-moe]'s depth, the
    prefill of [serve-moe]'s longest request (request 0 of the compared
    path) under expert parallelism on the (1, 1) mesh, with an f32 and a
    bf16 combine, against the same prefill under ``ParallelCtx()``; then,
    with the f32 combine, that prefill and ``DIST_DECODE_STEPS`` decode
    steps routed row by row (``sharded_decode``)."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model
    from repro_torch.roofline import counting
    cfg = dataclasses.replace(configs.get("deepseek-moe-16b"),
                              num_layers=MOE_LAYERS)
    reqs = make_requests(0, 8, (512, 1024), (8, 32), cfg.vocab_size)
    r0 = max(reqs, key=lambda r: len(r.prompt))
    S = len(r0.prompt)
    plain = Model(cfg, device="cuda")
    params = plain.init(torch.Generator(device="cuda").manual_seed(0))
    tok = torch.as_tensor(r0.prompt, device="cuda")[None]
    with torch.no_grad():
        want, _ = plain.prefill(params, {"tokens": tok}, max_len=S)
        base_ms = cuda_time_ms(lambda: plain.prefill(
            params, {"tokens": tok}, max_len=S), iters=3, warmup=1)
    out = {}
    for name, opt in (("ep", {}), ("ep_bf16", {"ep_bf16": True})):
        step, specs, _, _, model = dryrun.lower_cell(
            "deepseek-moe-16b", dist_ep_shape(S), mesh,
            overrides=dict(num_layers=MOE_LAYERS), opt=opt, device="cuda")
        dparams = sharding.distribute_local(
            params, mesh, sharding.param_shardings(mesh, params))
        batch = {"tokens": tok}
        dbatch = sharding.distribute_local(
            batch, mesh, sharding.batch_shardings(mesh, batch, 1))
        with torch.no_grad():
            with served_kernel_checks(f"dist-ep {name}") as seen:
                reset_launches()
                logits, _ = step(dparams, dbatch)
                torch.cuda.synchronize()
                n = b3_launches(f"dist-ep {name}", cfg.num_layers)
            ms = cuda_time_ms(lambda: step(dparams, dbatch), iters=3,
                              warmup=1)
            got = logits.full_tensor()
            equal = torch.equal(got, want)
            log(f"[dist-ep] {name}: logits bit-equal to ParallelCtx()'s "
                f"{equal} (max abs diff "
                f"{(got - want).abs().max().item():.3g}); B3 {n} launches, "
                f"each within its limit of the plain version on its served "
                f"inputs (max abs err {max(seen['b3']):.3g}, limits "
                f"{min(seen['b3_limit']):.3g}-{max(seen['b3_limit']):.3g}); "
                f"prefill {ms:.2f} ms (ParallelCtx() {base_ms:.2f} ms), "
                f"{S} tokens")
            if not equal:
                raise AssertionError(f"[dist-ep] {name}: the EP logits are "
                                     f"not bit-equal to ParallelCtx()'s")
            out[name] = {"launches": n, "ms": ms}
            if name == "ep":
                card = _collectives(counting.count_step(step, dparams,
                                                        dbatch))
                meta = twins["ep"]["collectives"]
                log(f"[dist-ep] collectives recorded on the card "
                    f"{len(card)}, on meta (fake group of 1) {len(meta)}: "
                    f"{card[:6]}{' ...' if len(card) > 6 else ''}")
                if card != meta:
                    raise AssertionError(f"[dist-ep] card collectives "
                                         f"{card} != meta {meta}")
                # the decode steps the server runs, routed row by row
                sharded_decode("dist-ep", plain, params, model, dparams,
                               mesh, tok)
        del dparams, logits, got
    record["launches_dist_ep"] = out["ep"]["launches"]
    record["dist_ep"] = {"prompt": S, "prefill_ms": out["ep"]["ms"],
                         "prefill_ms_bf16": out["ep_bf16"]["ms"],
                         "prefill_ms_plain": base_ms}
    del params, plain


def op_trace(fn, *args) -> list:
    """(op, shape, f64 sum) of every floating aten op that ``fn`` runs on
    plain (local) tensors, views and collectives aside: the sequence two
    runs are compared by when their results differ."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = []

    class Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t.__name__ == "DTensor" for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if (not func.is_view and func.namespace == "aten"
                    and isinstance(out, torch.Tensor)
                    and out.is_floating_point() and out.numel()
                    and str(func.overloadpacket) not in (
                        "aten.clone", "aten.detach", "aten._to_copy",
                        "aten.copy_", "aten.zeros_like", "aten.empty",
                        "aten.empty_like", "aten.empty_strided",
                        "aten.new_empty", "aten.new_empty_strided")):
                seen.append((str(func.overloadpacket), tuple(out.shape),
                             out.double().sum().item()))
            return out
    with Trace():
        fn(*args)
    return seen


def first_difference(a: list, b: list):
    """The first result of ``a`` (the unsharded step's ``op_trace``) whose
    (shape, sum) no result of ``b`` (the sharded step's) has, each of b's
    matched once (the sharded path runs extra ops, such as the loss's
    masked pick, in another order, and may call one op by another name):
    (index in a, op, shape, sum), or None when every result is found."""
    left: dict = {}
    for _, shape, total in b:
        left[(shape, total)] = left.get((shape, total), 0) + 1
    for i, (op, shape, total) in enumerate(a):
        if left.get((shape, total), 0) == 0:
            return i, op, shape, total
        left[(shape, total)] -= 1
    return None


def dist_train(record: dict, mesh, twins: dict) -> None:
    """[dist-train]: full-width StableLM-2 1.6B at [train-lm]'s depth,
    ``DIST_TRAIN_STEPS`` AdamW steps of one lane's batch with params,
    moments and batch placed by ``param_shardings``/``batch_shardings``
    (fsdp) on the (1, 1) mesh, B3 through ``local_map``, against the same
    steps unsharded; ``compressed_psum`` of the real gradients and
    ``allgather_matmul`` on the one-rank group."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs, optim
    from repro_torch.core import packing
    from repro_torch.distributed import sharding
    from repro_torch.distributed.collectives import allgather_matmul
    from repro_torch.distributed.compression import (compressed_psum,
                                                      dequantize_int8,
                                                      quantize_int8)
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import mesh_grads
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(configs.get("stablelm-1.6b"),
                              num_layers=TRAIN_LM_LAYERS)
    plain = Model(cfg, device="cuda")
    params = plain.init(torch.Generator(device="cuda").manual_seed(0))
    opt = optim.adamw()
    lr = torch.tensor(DIST_TRAIN_LR, device="cuda")
    bf = lm_batch_fn(cfg, TRAIN_LM_SEQ, TRAIN_LM_BATCH)
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in bf(0, i).items()} for i in range(DIST_TRAIN_STEPS)]
    # the unsharded steps differentiate as the sharded ones must, by
    # torch.autograd; the torch.func route is held below
    def step_u(p, o, b, lr):
        g, m = mesh_grads(plain.loss, p, b)
        m = dict(m, grad_norm=optim.global_norm(g))
        updates, o = opt.update(g, o, p, lr)
        return optim.apply_updates(p, updates), o, m

    step_s, _, _, _, model = dryrun.lower_cell(
        "stablelm-1.6b", dist_train_shape(), mesh,
        overrides=dict(num_layers=TRAIN_LM_LAYERS), device="cuda")
    place = sharding.param_shardings(mesh, params, fsdp=True)

    def shard(tree, pl):
        return sharding.distribute_local(tree, mesh, pl)

    def run(step, p, o, bs, sharded):
        losses, walls = [], []
        for b in bs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = step(p, o, b, lr)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            losses.append(m["loss"].full_tensor() if sharded else m["loss"])
        return p, o, losses, walls

    copy = lambda t: packing.tree_map(lambda x: x.clone(), t)  # noqa: E731
    pu, ou, lu, wu = run(step_u, copy(params), opt.init(params), batches,
                         False)
    dparams = shard(copy(params), place)
    dopt = {"mu": shard(opt.init(params)["mu"], place),
            "nu": shard(opt.init(params)["nu"], place),
            "count": torch.zeros((), dtype=torch.int32, device="cuda")}
    dbatches = [shard(b, sharding.batch_shardings(mesh, b, TRAIN_LM_BATCH))
                for b in batches]
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    ps, os_, ls, ws = run(step_s, dparams, dopt, dbatches, True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    n = b3_launches("dist-train", DIST_TRAIN_STEPS * TRAIN_LM_LAYERS * 2)
    record["launches_dist_train"] = n
    leaves_u, leaves_s = packing.tree_leaves(pu), [
        t.full_tensor() for t in packing.tree_leaves(ps)]
    loss_equal = all(torch.equal(a, b) for a, b in zip(ls, lu))
    leaf_equal = all(torch.equal(a, b) for a, b in zip(leaves_s, leaves_u))
    rel = max(max((a - b).abs().max().item() / max(b.abs().max().item(),
                                                    1e-30)
                   for a, b in zip(leaves_s, leaves_u)),
              max(abs(a.item() - b.item()) / abs(b.item())
                  for a, b in zip(ls, lu)))
    log(f"[dist-train] {cfg.name} {cfg.num_layers} layers, batch "
        f"{TRAIN_LM_BATCH} x {TRAIN_LM_SEQ}, {DIST_TRAIN_STEPS} AdamW steps: "
        f"losses sharded {[round(x.item(), 6) for x in ls]}, unsharded "
        f"{[round(x.item(), 6) for x in lu]}; losses bit-equal {loss_equal}, "
        f"every updated leaf bit-equal {leaf_equal} (largest relative "
        f"difference {rel:.3g})")
    if not (loss_equal and leaf_equal):
        p0 = params
        trace_u = op_trace(lambda: mesh_grads(plain.loss, p0, batches[0]))
        trace_s = op_trace(lambda: mesh_grads(model.loss, shard(
            copy(p0), place), dbatches[0]))
        first = first_difference(trace_u, trace_s)
        log(f"[dist-train] first op of the unsharded step whose result "
            f"the sharded one does not reproduce (ops of {len(trace_u)} "
            f"unsharded, {len(trace_s)} sharded): {first}")
        g_u, _ = mesh_grads(plain.loss, p0, batches[0])
        g_s, _ = mesh_grads(model.loss, shard(copy(p0), place),
                            dbatches[0])
        names = [".".join(map(str, path)) for path, _ in
                 sharding.flatten_with_path(p0)]
        diff = [(n, (a.full_tensor() - b).abs().max().item())
                for n, a, b in zip(names, packing.tree_leaves(g_s),
                                   packing.tree_leaves(g_u))
                if not torch.equal(a.full_tensor(), b)]
        log(f"[dist-train] step 0's gradients not bit-equal: {diff}")
        if rel > DIST_TRAIN_RTOL:
            raise AssertionError(f"[dist-train] sharded and unsharded steps "
                                 f"differ by {rel:.3g} relative > "
                                 f"{DIST_TRAIN_RTOL}")
    # the mesh step's step-0 gradients against the unsharded torch.func
    # route's (make_train_step's for plain params), relative to each leaf's
    # largest entry: held with the compute in f32, read in the path's bf16
    grads, _ = mesh_grads(model.loss, shard(copy(params), place),
                          dbatches[0])
    f32 = dict(num_layers=TRAIN_LM_LAYERS, compute_dtype="float32")
    model32 = dryrun.lower_cell("stablelm-1.6b", dist_train_shape(), mesh,
                                overrides=f32, device="cuda")[4]
    plain32 = Model(dataclasses.replace(cfg, **f32), device="cuda")
    func_rel = {}
    for name, m_mesh, m_plain, g_mesh in (
            ("f32", model32, plain32, None), ("bf16", model, plain, grads)):
        if g_mesh is None:
            g_mesh, _ = mesh_grads(m_mesh.loss, shard(copy(params), place),
                                   dbatches[0])
        g_func, _ = torch.func.grad_and_value(m_plain.loss, has_aux=True)(
            params, batches[0])
        func_rel[name] = max(
            (a.full_tensor() - b).abs().max().item()
            / max(b.abs().max().item(), 1e-30)
            for a, b in zip(packing.tree_leaves(g_mesh),
                            packing.tree_leaves(g_func)))
        del g_mesh, g_func
    log(f"[dist-train] step 0's gradients on the mesh against the "
        f"unsharded torch.func route's, largest difference of a leaf's "
        f"largest entry: f32 compute {func_rel['f32']:.3g} (limit "
        f"{DIST_TRAIN_RTOL}), bf16 compute {func_rel['bf16']:.3g} (limit "
        f"{DIST_TRAIN_BF16_RTOL})")
    for name, limit in (("f32", DIST_TRAIN_RTOL),
                        ("bf16", DIST_TRAIN_BF16_RTOL)):
        if not func_rel[name] <= limit:
            raise AssertionError(f"[dist-train] mesh and torch.func "
                                 f"gradients in {name} differ by "
                                 f"{func_rel[name]:.3g} of a leaf's largest "
                                 f"entry > {limit}")
    del model32, plain32
    # compressed_psum of the real gradients on the one-rank group
    n_ok = 0
    for g in packing.tree_leaves(grads):
        g = g.to_local()
        q, s = quantize_int8(g)
        for scheme, want in (("fp32", g.float()),
                             ("bf16", g.bfloat16().float()),
                             ("int8", dequantize_int8(q, s))):
            got = compressed_psum(g, dist.group.WORLD, scheme)
            if not torch.equal(got, want):
                raise AssertionError(f"[dist-train] compressed_psum "
                                     f"{scheme} of a gradient {tuple(g.shape)}"
                                     f" is not its one-rank value")
        n_ok += 1
    x = torch.randn(64, cfg.d_model, device="cuda")
    w = params["blocks"]["mlp"]["w_up"][0]
    agm = allgather_matmul(x, w, dist.group.WORLD)
    if not torch.equal(agm, x @ w):
        raise AssertionError("[dist-train] allgather_matmul != x @ W")
    pred = twins["train"]["arg_bytes"] + twins["train"]["live_peak_bytes"]
    log(f"[dist-train] compressed_psum fp32/bf16/int8 of {n_ok} gradients "
        f"equal to g, g.bfloat16().float() and dequantize(quantize(g)); "
        f"allgather_matmul at world size 1 equal to x @ W")
    log(f"[dist-train] step wall sharded {[round(v, 1) for v in ws]} ms, "
        f"unsharded {[round(v, 1) for v in wu]} ms (host clock, no child "
        f"process running; DTensor's host overhead at one rank); peak above what was held before the "
        f"steps {peak / 1e9:.3f} GB (max_memory_allocated: each step's new "
        f"params and moments and its temporaries), dry-run prediction "
        f"arg + whole peak {pred / 1e9:.3f} GB (arg "
        f"{twins['train']['arg_bytes'] / 1e9:.3f} + the whole peak of what "
        f"the step makes, outputs included, "
        f"{twins['train']['live_peak_bytes'] / 1e9:.3f}, counted on meta)")
    record["dist_train"] = {"wall_ms_sharded": ws, "wall_ms_unsharded": wu,
                            "peak_gb": peak / 1e9,
                            "predicted_arg_temp_gb": pred / 1e9,
                            "bit_equal": loss_equal and leaf_equal,
                            "max_rel": rel, "func_grad_rel_f32": func_rel["f32"],
                            "func_grad_rel_bf16": func_rel["bf16"]}


def gc_collect() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_phase(results: dict) -> None:
    """[dryrun]: every cell's child exited 0 with an OK line; each row's
    ``arg_gb_dev`` equals the argument bytes summed from its specs; each
    multi-pod cell carries collective bytes on its pod axis (alone, or
    with "data" in one collective over their flattened group); each cell's
    temp (its outputs left out, as the reference's) within twice the
    reference's and its TFLOP within 1.25 times, the collectives of
    ``DRYRUN_COLL_GATED``'s cells within twice the reference's and the
    others' ratio printed; arg + peak per device
    (the peak of temporaries and outputs together, what the card's
    allocator would hold) printed beside 80 GB (a reading, not a gate),
    and the outputs' bytes."""
    for (arch, shape, mesh), (label, (rc, text, secs)) in zip(
            DRYRUN_CELLS, results.items()):
        ok_lines = [ln for ln in text.splitlines()
                    if ln.startswith("[dryrun]")]
        for ln in ok_lines:
            log(ln)
        if rc != 0 or not any(ln.startswith("[dryrun] OK") for ln in
                              ok_lines):
            log(text[-3000:])
            raise AssertionError(f"[dryrun] {label}: exit code {rc}")
        mname = "2podx16datax16model" if mesh == "multi" \
            else "16datax16model"
        row = json.loads((DRYRUN_OUT / f"{arch}__{shape}__{mname}.json")
                         .read_text())
        if row["arg_gb_dev"] != row["arg_gb_dev_from_specs"]:
            raise AssertionError(f"[dryrun] {label}: arg_gb_dev "
                                 f"{row['arg_gb_dev']} != "
                                 f"{row['arg_gb_dev_from_specs']} from the "
                                 f"specs")
        # a collective over the pod axis alone or over a group of it and
        # other axes ("pod+data": a gather over their flattened group)
        on_pod = sum(gb for axes, gb in row["coll_by_axis_gb"].items()
                     if "pod" in axes.split("+"))
        if mesh == "multi" and not on_pod > 0:
            raise AssertionError(f"[dryrun] {label}: no collective bytes on "
                                 f"the pod axis: {row['coll_by_axis_gb']}")
        total = row["arg_gb_dev"] + row["peak_gb_dev"]
        ref_temp, ref_tflop, ref_coll = DRYRUN_REFERENCE[(arch, shape, mesh)]
        tflop = row["gflops_dev"] / 1e3
        coll = row["coll_gb_dev"]
        log(f"[dryrun] {label}: arg + peak {total:.2f} GB a device beside "
            f"the card's 80 GB ({'fits' if total <= 80 else 'does not fit'}"
            f"; a count against HW.h100's data-sheet constants, not a "
            f"measurement); out {row['out_gb_dev']:.4g} GB; temp "
            f"{row['temp_gb_dev']:.4g} GB beside the reference's "
            f"{ref_temp:.4g} ({row['temp_gb_dev'] / ref_temp:.3f}x); "
            f"{tflop:.4g} TFLOP beside the reference's {ref_tflop:.4g} "
            f"({tflop / ref_tflop:.3f}x); collectives {coll:.4g} GB "
            f"beside the reference's {ref_coll:.4g} "
            f"({coll / ref_coll:.3f}x"
            f"{', gated' if (arch, shape, mesh) in DRYRUN_COLL_GATED else ''}"
            f"), by axis {row['coll_by_axis_gb']}; {secs:.1f} s")
        if (arch, shape, mesh) in DRYRUN_COLL_GATED and \
                not coll <= DRYRUN_COLL_RATIO * ref_coll:
            raise AssertionError(f"[dryrun] {label}: collectives {coll:.4g}"
                                 f" GB a device > {DRYRUN_COLL_RATIO} x the "
                                 f"reference's {ref_coll:.4g}")
        if not row["temp_gb_dev"] <= DRYRUN_TEMP_RATIO * ref_temp:
            raise AssertionError(f"[dryrun] {label}: temp "
                                 f"{row['temp_gb_dev']:.2f} GB a device > "
                                 f"{DRYRUN_TEMP_RATIO} x the reference's "
                                 f"{ref_temp}")
        if not tflop <= DRYRUN_TFLOP_RATIO * ref_tflop:
            raise AssertionError(f"[dryrun] {label}: {tflop:.4g} TFLOP a "
                                 f"device > {DRYRUN_TFLOP_RATIO} x the "
                                 f"reference's {ref_tflop:.4g}")


def dist_phases(record: dict, rec_b4: dict) -> None:
    """Phase 9: the meta twins count in a child first; [dist-ep],
    [dist-ssm] and [dist-train] run on a NCCL group of one rank with no
    child running (so that their host walls are not taken under its
    load); then the [dryrun] cells run as children and [dryrun] reads
    them."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    cfg = configs.get("deepseek-moe-16b")
    reqs = make_requests(0, 8, (512, 1024), (8, 32), cfg.vocab_size)
    ep_len = max(len(r.prompt) for r in reqs)
    ssm_len = max(len(r.prompt) for r in ssm_requests(
        configs.get("mamba2-130m").vocab_size))
    if DRYRUN_OUT.exists():
        shutil.rmtree(DRYRUN_OUT)
    root = str(Path(__file__).resolve().parent)
    kids = [start_child("meta twins", [
        "-c", f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
        f"chip_smoke.meta_twins({ep_len}, {ssm_len})"])]
    try:
        rc, text, secs = finish_children(kids, timeout=600)["meta twins"]
        if rc != 0:
            log(text[-3000:])
            raise AssertionError("[dist] the meta twins' child failed")
        log(f"[dist] meta twins counted in {secs:.1f} s")
        twins = json.loads(text.strip().splitlines()[-1])
        with nccl_world():
            mesh = make_mesh((1, 1), ("data", "model"))
            dist_ep(record, mesh, twins)
            gc_collect()
            dist_ssm(rec_b4, mesh, twins)
            gc_collect()
            dist_train(record, mesh, twins)
            gc_collect()
        t0 = time.perf_counter()
        kids = start_dryrun_cells()
        results = finish_children(kids)
        log(f"[dryrun] {len(kids)} cells counted in parallel in "
            f"{time.perf_counter() - t0:.1f} s")
        dryrun_phase(results)
    finally:
        for _, p, _ in kids:
            if p.poll() is None:
                p.kill()
                p.communicate()


# ---------------------------------------------------------------------------
# phase 10: the entry scripts
# ---------------------------------------------------------------------------

EXAMPLE_CKPT = Path(__file__).resolve().parent / "build" / "examples" / \
    "train_lm_ckpt"
EXAMPLES = (("quickstart", []),
            ("parametric_sweep", ["--tasks", "2", "--steps", "3"]),
            ("serve_batch", []),
            ("train_lm", ["--steps", "20", "--ckpt", str(EXAMPLE_CKPT)]))


def examples() -> None:
    """[examples]: the four ``examples/torch_*.py`` scripts on the card as
    child processes, started together; each must exit 0."""
    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    kids = [start_child(name, [f"examples/torch_{name}.py", *args])
            for name, args in EXAMPLES]
    failed = []
    try:
        done = finish_children(kids, timeout=600)
    finally:
        for _, p, _ in kids:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, _ in EXAMPLES:
        rc, text, secs = done[name]
        for line in text.splitlines():
            if line.strip():
                log(f"[examples] {name}: {line}")
        log(f"[examples] {name}: exit {rc}, done within {secs:.1f} s of the "
            f"phase's start")
        if rc != 0:
            failed.append(name)
    assert not failed, f"examples failed: {failed}"


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    card, logs = setup()
    t_setup = time.perf_counter()
    resources = analysis(logs)
    t_analysis = time.perf_counter()
    records = [check_flash_attention(), check_packed_gemm(), *check_rmsnorm(),
               check_ssd_scan()]
    attach_resources(records, resources)
    check_mamba2_gradient()
    check_small_reference()
    check_small_families()
    serve_paths(records[0], records[4])
    t1 = time.perf_counter()
    serve_embeds_paths(records[0])
    t2 = time.perf_counter()
    lenet_pool, lenet_batch = train_lenet()
    kernel_args = train_kernel(records[1])
    profile_training(lenet_pool, lenet_batch, kernel_args)
    del lenet_pool, lenet_batch, kernel_args
    train_lm(records[0])
    t3 = time.perf_counter()
    train_resnet()
    t4 = time.perf_counter()
    moe = train_family("train-moe", "deepseek-moe-16b", records[0],
                       records[4])
    t5 = time.perf_counter()
    train_family("train-hybrid", "zamba2-7b", records[0], records[4])
    t6 = time.perf_counter()
    roofline(records[0], moe)
    del moe
    t7 = time.perf_counter()
    policy_phases(records[0])
    t8 = time.perf_counter()
    dist_phases(records[0], records[4])
    t9 = time.perf_counter()
    examples()
    t10 = time.perf_counter()
    log(f"[done] {t10 - t0:.1f} s; set-up {t_setup - t0:.1f} s, "
        f"[analysis] {t_analysis - t_setup:.1f} s, [serve-vlm] and "
        f"[serve-encdec] "
        f"{t2 - t1:.1f} s, training phases {t3 - t2:.1f} s, [train-resnet] "
        f"{t4 - t3:.1f} s, [train-moe] {t5 - t4:.1f} s, [train-hybrid] "
        f"{t6 - t5:.1f} s, [roofline] {t7 - t6:.1f} s, policy phases "
        f"{t8 - t7:.1f} s, distributed phases {t9 - t8:.1f} s, [examples] "
        f"{t10 - t9:.1f} s")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
