#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py          # from the root of a repository checkout

Phases, in order; any failure propagates and the exit code is non-zero:

1. set-up: build every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once), print each kernel's registers
   and spills (``ptxas -v``), count the tensor-core (HGMMA),
   TMA (UTMALDG) and mbarrier (SYNCS) instructions in the SASS of the B1
   and B3 libraries and the tensor-core (HMMA), cp.async (LDGSTS) and
   ldmatrix (LDSM) instructions in B4's, print the card's name and power
   limit, turn TF32 off;
2. [kernel] each kernel against its plain PyTorch version on the card:
   flash attention (B3) at the serving path's shape and at GQA / window /
   f32 / ragged / lane-masked cases, at head dims 16 (the reduced configs,
   f32) and 112 (zamba2-7b, bf16) too, at [train-lm]'s pool-step shape
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
   serving prefill's shape, in f32 and bf16, through the model's strided
   views and lane-masked, its three CUDA kernels timed apart; a Mamba2
   block's gradient on the card (through the chunked scan, no B4 launch)
   against the CPU's; each timed beside its bound and, where one
   exists, a PyTorch library call (CUDA events and profiler device time
   for both);
   B1 and B3 run their tensor-core (wgmma) bodies on bf16 and their
   CUDA-core (simt) bodies on f32;
3. [small] narrow f32 models served on the card (kernel path) and on the
   CPU (chunked path) from the same parameters must agree: a head-dim-64
   variant of the reduced StableLM-2 and the stock reduced config (head
   dim 16);
4. [serve] the serving path: ``BatchServer`` serving 8 requests on
   full-width StableLM-2 1.6B (random weights from a seed), with every
   kernel's launch count read around that run (B3's by body: all on the
   tensor-core body), then the same requests with
   ``adaptive_lanes``; [profile] device time by kernel and the device's idle
   share for one prefill and one 4-lane decode step (torch.profiler);
   [serve-ssm] the same for full-width mamba2-130m, whose prefills run B4
   (24 launches each), with its own [profile];
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
   ``adaptive_pack`` sweep and the card's losses against the CPU's.

The last three lines of standard output are the ``nvidia-smi`` name/power
line, a JSON object with one record per kernel, and the result line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import dataclasses
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

def setup() -> str:
    import torch
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {sorted(logs) or 'cached'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for kernel, regs, spill_st, spill_ld in kernel_resources(text):
            log(f"[build] {name}: {kernel}: {regs} registers, spill stores "
                f"{spill_st} B, spill loads {spill_ld} B")
    check_sass()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[card] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def kernel_resources(ptxas_log: str) -> list:
    """(kernel, registers, spill-store bytes, spill-load bytes) of each
    entry function in an ``nvcc -Xptxas -v`` log, names demangled by the
    toolkit's cu++filt where it has one."""
    rows, name, spills = [], None, ("?", "?")
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), ("?", "?")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append([name, int(m.group(1)), *spills])
            name = None
    filt = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cu++filt")
    if rows and os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for row, pretty in zip(rows, names):
                row[0] = pretty.replace("(anonymous namespace)::", "")
    return [tuple(r) for r in rows]


def _cuobjdump() -> str:
    """The toolkit's cuobjdump: on PATH, under CUDA_HOME, or the copy in
    Triton's package."""
    cands = [shutil.which("cuobjdump"), os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")]
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    import triton
    cand = Path(triton.__file__).parent / "backends/nvidia/bin/cuobjdump"
    if cand.exists():
        return str(cand)
    raise AssertionError("cuobjdump not found: the SASS check needs it")


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
    from repro_torch.kernels import _build
    tool = _cuobjdump()
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
    v read once and o written once at the memory rate."""
    import torch
    q_pos = torch.arange(Sq)[:, None]
    k_pos = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    flops = 4 * B * Hq * D * int(mask.sum())
    nbytes = (2 * B * Sq * Hq + 2 * B * Sk * Hkv) * D * dtype.itemsize
    return bound_ms(flops, nbytes, PEAK_FLOPS[str(dtype)])


def _qkv(gen, B, Sq, Sk, Hq, Hkv, D, dtype):
    import torch
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    return mk(B, Sq, Hq, D), mk(B, Sk, Hkv, D), mk(B, Sk, Hkv, D)


def check_flash_attention() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
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
        ("d112_window", 1, 777, 777, 32, 32, 112, bf16, True, 256),
        ("d16_causal", 2, 300, 300, 4, 2, 16, bf16, True, 0),
        # [train-lm]'s pool step: 2 lanes of batch 2 folded into B
        ("train_lm", 4, 512, 512, 32, 32, 64, bf16, True, 0),
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
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:159",
            "launches": None, "max_abs_err": errs["prefill"], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_device_ms": library_dev_ms}


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
    gradient."""
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
        for causal, window in masks:
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
                grads[name] = torch.func.vmap(torch.func.grad(
                    loss, argnums=(0, 1, 2)))(q, k, v, w)
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
                f"{(B, S, Hq, D)} {dt} causal={causal} window={window}: one "
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
        b_ms, b_by = bound_ms(2 * J * M * K * N,
                              (J * M * K + J * K * N + J * M * N)
                              * dt.itemsize, PEAK_FLOPS[str(dt)])
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
    """RMSNorm: ~4 f32 operations per element; x and w read, out written."""
    return bound_ms(4 * x.numel(), (2 * x.numel() + w.numel())
                    * x.element_size(), PEAK_FLOPS["torch.float32"])


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


def ssd_work(b, S, nh, hd, N, Q, itemsize) -> tuple:
    """(f32 operations, bytes) of the SSD scan on these shapes: C·Bᵀ and
    the intra-chunk product over the causal half of each chunk (j <= i),
    the inter-chunk and state products in full; x, B, C read and y written
    in their dtype, dt read and the state written in f32."""
    nc, tri = S // Q, Q * (Q + 1) // 2
    flops = b * nc * (2 * N * tri + 2 * nh * hd * tri + 4 * Q * N * nh * hd)
    nbytes = ((2 * b * S * nh * hd + 2 * b * S * N) * itemsize
              + 4 * (b * S * nh + nh + b * nh * hd * N))
    return flops, nbytes


def ssd_bound_ms(b, S, nh, hd, N, Q, itemsize) -> tuple:
    """Least time for the SSD scan: its f32 operations at the f32 peak,
    against its bytes."""
    return bound_ms(*ssd_work(b, S, nh, hd, N, Q, itemsize),
                    PEAK_FLOPS["torch.float32"])


def ssd_tensor_core_bound_ms(b, S, nh, hd, N, Q, itemsize) -> tuple:
    """Least time for the same work on the route the kernel takes: each
    f32 product as three exact bf16 products at the bf16 tensor-core
    peak, against the same bytes."""
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
    ``serve_ssm``."""
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
             (4, 512, 24, 64, 128, 128, True), SSD_SERVE + (True,)]
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
            "device_ms_4_sequences": dev4_ms,
            "max_abs_err": errs[SSD_SERVE + ("torch.bfloat16",)], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "library_device_ms": None}


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


def check_small_reference() -> None:
    """Narrow f32 models served on the card through the kernel and on the
    CPU through the chunked path, from the same parameters: prefill logits
    agree and tokens match. Two configs: the reduced StableLM-2 at head dim
    64 and the stock reduced config (head dim 16, as every ``reduced()``
    config), both through B3's f32 body."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models.model import Model
    reduced = configs.get("stablelm-1.6b").reduced()
    variants = (("head_dim 64", dataclasses.replace(
        reduced, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64)),
        ("stock reduced, head_dim 16", reduced))
    for label, cfg in variants:
        cpu_model = Model(cfg, device="cpu")
        cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
        gpu_model = Model(cfg, device="cuda")
        gpu_params = _tree_to(cpu_params, "cuda")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 150)))
        before = fa.flash_attention_cuda.launches_by_body["simt"]
        lc, _ = cpu_model.prefill(cpu_params, {"tokens": toks}, max_len=192)
        lg, _ = gpu_model.prefill(gpu_params, {"tokens": toks.cuda()},
                                  max_len=192)
        launched = fa.flash_attention_cuda.launches_by_body["simt"] - before
        err = (lg.cpu() - lc).abs().max().item()
        log(f"[small] {label}: f32 prefill logits card (kernel, {launched} "
            f"B3 launches on the simt body) vs cpu (chunked): max_abs_err "
            f"{err:.3g} (atol {SMALL_LOGIT_ATOL_F32})")
        if not err <= SMALL_LOGIT_ATOL_F32 or launched != cfg.num_layers:
            raise AssertionError(f"small reference {label}: logits differ "
                                 f"by {err}, {launched} B3 launches")
        outs = []
        for model, params in ((cpu_model, cpu_params),
                              (gpu_model, gpu_params)):
            reqs = make_requests(2, 5, (40, 120), (2, 9), cfg.vocab_size)
            outs.append(BatchServer(model, params, batch_lanes=2,
                                    max_len=160).run(reqs))
        if outs[0] != outs[1]:
            raise AssertionError(f"small reference {label}: card and cpu "
                                 f"tokens differ")
        log(f"[small] {label}: served 5 requests: card tokens == cpu tokens")


def serve_full(record: dict):
    """The main path; sets ``record["launches"]`` from its run. Returns
    (model, params, longest prompt) for the profile."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ParallelCtx
    cfg = configs.get("stablelm-1.6b")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B params f32, init "
        f"{time.perf_counter() - t0:.1f} s")

    reqs = make_requests(0, 8, (512, 1024), (8, 32), cfg.vocab_size)
    total_new = sum(r.max_new for r in reqs)
    srv = BatchServer(model, params, batch_lanes=4, max_len=2048)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = srv.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from repro_torch.kernels import flash_attention as fa
    launches = read_launches()["flash_attention_fwd"]
    by_body = dict(fa.flash_attention_cuda.launches_by_body)
    record["launches"] = launches
    record["launches_by_body"] = by_body
    st = srv.stats
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_tokens = st.lane_steps - st.prefills
    log(f"[serve] 8 requests, prompts {min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, max_new "
        f"{min(r.max_new for r in reqs)}-{max(r.max_new for r in reqs)}: "
        f"wall {wall:.3f} s, prefills {st.prefills}, global_steps "
        f"{st.global_steps}, lane_steps {st.lane_steps}, lane_slots "
        f"{st.lane_slots}, flash_attention launches {launches} (by body "
        f"{by_body})")
    log(f"[serve] prefill {1e3 * st.prefill_s / st.prefills:.2f} ms/request "
        f"(S_pad {max(len(r.prompt) for r in reqs)}), decode "
        f"{decode_tokens / st.decode_s:.1f} tokens/s over "
        f"{st.global_steps} steps ({1e3 * st.decode_s / st.global_steps:.2f}"
        f" ms/step), peak memory {peak_gb:.2f} GB")
    if st.lane_steps != total_new:
        raise AssertionError(f"lane_steps {st.lane_steps} != Σ max_new "
                             f"{total_new}")
    if launches != st.prefills * N_LAYERS_FULL or launches == 0:
        raise AssertionError(f"flash_attention launches {launches} != "
                             f"prefills {st.prefills} x {N_LAYERS_FULL}")
    if by_body["wgmma"] != launches:
        raise AssertionError(f"flash_attention: the bf16 prefills launched "
                             f"the tensor-core body {by_body['wgmma']} of "
                             f"{launches} times")
    for r in reqs:
        toks = out[r.id]
        if len(toks) != r.max_new or not all(0 <= t < cfg.padded_vocab
                                             for t in toks):
            raise AssertionError(f"request {r.id}: bad tokens {toks}")

    # last-position prefill logits: kernel vs plain version on the card
    r0 = reqs[0]
    toks = torch.from_numpy(r0.prompt[None]).cuda()
    with torch.inference_mode():
        lk, _ = model.prefill(params, {"tokens": toks}, max_len=2048)
        plain = Model(cfg, ParallelCtx(attn_impl="plain"), device="cuda")
        lp, _ = plain.prefill(params, {"tokens": toks}, max_len=2048)
    err = (lk - lp).abs().max().item()
    log(f"[serve] request 0 prefill logits, kernel vs plain: max_abs_err "
        f"{err:.4g} (atol {LOGIT_ATOL_BF16}), logit std "
        f"{lp.std().item():.3f}, argmax equal "
        f"{bool(lk.argmax() == lp.argmax())}")
    if not (torch.isfinite(lk).all() and err <= LOGIT_ATOL_BF16):
        raise AssertionError(f"prefill logits: kernel vs plain err {err}")

    # the same requests with adaptive lanes
    reqs2 = make_requests(0, 8, (512, 1024), (8, 32), cfg.vocab_size)
    srv2 = BatchServer(model, params, batch_lanes=4, max_len=2048,
                       adaptive_lanes=True)
    out2 = srv2.run(reqs2)
    agree = sum(a == b for r in reqs for a, b in zip(out[r.id], out2[r.id]))
    firsts = all(out[r.id][0] == out2[r.id][0] for r in reqs)
    log(f"[serve] adaptive_lanes: resizes {srv2.stats.resizes}, lane_slots "
        f"{srv2.stats.lane_slots} vs {st.lane_slots}; tokens agreeing with "
        f"the fixed pool {agree}/{total_new} ({agree / total_new:.3f}); "
        f"first tokens equal {firsts}")
    if srv2.stats.lane_steps != total_new or not firsts:
        raise AssertionError("adaptive run: lane_steps or first tokens off")
    return model, params, max((r.prompt for r in reqs), key=len)


def ssm_requests(vocab: int):
    """8 requests from numpy seed 0: prompts 512-1024 tokens, the longest
    exactly 1024 (S_pad = 8 SSD chunks of 128), max_new 12-32."""
    reqs = make_requests(0, 8, (512, 1024), (12, 32), vocab)
    longest = max(reqs, key=lambda r: len(r.prompt))
    extra = np.random.default_rng(1).integers(
        0, vocab, 1024 - len(longest.prompt)).astype(np.int64)
    longest.prompt = np.concatenate([longest.prompt, extra])
    return reqs


def serve_ssm(record: dict):
    """The SSM serving path: ``BatchServer`` on full-width mamba2-130m;
    sets ``record["launches"]`` (B4) from its run. Returns (model, params,
    longest prompt) for the profile."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ParallelCtx
    cfg = configs.get("mamba2-130m")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve-ssm] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, SSD chunk {cfg.ssm.chunk_size}, "
        f"{n_params / 1e6:.1f} M params f32, init "
        f"{time.perf_counter() - t0:.1f} s")

    reqs = ssm_requests(cfg.vocab_size)
    total_new = sum(r.max_new for r in reqs)
    srv = BatchServer(model, params, batch_lanes=4, max_len=2048)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = srv.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    from repro_torch.kernels import ssd_scan as sd
    record["launches"] = launches["ssd_scan"]
    record["launches_by_body"] = dict(sd.ssd_scan_cuda.launches_by_body)
    record["scalar_reads"] = sd.ssd_scan_cuda.scalar_reads
    st = srv.stats
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_tokens = st.lane_steps - st.prefills
    s_pad = max(len(r.prompt) for r in reqs)
    log(f"[serve-ssm] 8 requests, prompts {min(len(r.prompt) for r in reqs)}"
        f"-{s_pad} tokens, max_new {min(r.max_new for r in reqs)}-"
        f"{max(r.max_new for r in reqs)}: wall {wall:.3f} s, prefills "
        f"{st.prefills}, global_steps {st.global_steps}, lane_steps "
        f"{st.lane_steps}, lane_slots {st.lane_slots}, launches {launches}; "
        f"ssd_scan by body {record['launches_by_body']}, scalar row reads "
        f"{record['scalar_reads']}")
    log(f"[serve-ssm] prefill {1e3 * st.prefill_s / st.prefills:.2f} "
        f"ms/request (S_pad {s_pad}), decode "
        f"{decode_tokens / st.decode_s:.1f} tokens/s over {st.global_steps} "
        f"steps ({1e3 * st.decode_s / st.global_steps:.2f} ms/step), peak "
        f"memory {peak_gb:.2f} GB")
    if st.lane_steps != total_new:
        raise AssertionError(f"lane_steps {st.lane_steps} != Σ max_new "
                             f"{total_new}")
    if launches["ssd_scan"] != st.prefills * N_LAYERS_FULL \
            or launches["ssd_scan"] == 0:
        raise AssertionError(f"ssd_scan launches {launches['ssd_scan']} != "
                             f"prefills {st.prefills} x {N_LAYERS_FULL}")
    if record["launches_by_body"]["bf16"] != launches["ssd_scan"] \
            or record["scalar_reads"]:
        raise AssertionError(f"ssd_scan: bodies "
                             f"{record['launches_by_body']} for "
                             f"{launches['ssd_scan']} calls, "
                             f"{record['scalar_reads']} with scalar row "
                             f"reads")
    # the same run again under torch.profiler, every count set to 0 just
    # before it: B4's CUDA kernels counted in the trace, each once a call
    traced = {}

    def run_traced():
        fresh = ssm_requests(cfg.vocab_size)     # the server fills r.out
        reset_launches()
        BatchServer(model, params, batch_lanes=4, max_len=2048).run(fresh)
        traced.update(read_launches())

    by_name: dict = {}
    for e in device_events(run_traced):
        name = kernel_name(e)
        if name.startswith("ssd_"):
            by_name[name] = by_name.get(name, 0) + 1
    calls = traced["ssd_scan"]
    record["kernels"] = sum(by_name.values())
    record["kernels_by_name"] = by_name
    log(f"[serve-ssm] traced run: {calls} ssd_scan calls, CUDA kernels in "
        f"the trace {record['kernels']} {by_name}")
    if calls != launches["ssd_scan"] or not by_name \
            or set(by_name.values()) != {calls}:
        raise AssertionError(f"ssd_scan: the traced run made {calls} calls "
                             f"(untraced {launches['ssd_scan']}) and "
                             f"launched {by_name}")
    for r in reqs:
        toks = out[r.id]
        if len(toks) != r.max_new or not all(0 <= t < cfg.padded_vocab
                                             for t in toks):
            raise AssertionError(f"request {r.id}: bad tokens {toks}")

    # the longest prompt's prefill logits: kernel vs plain version
    r0 = max(reqs, key=lambda r: len(r.prompt))
    toks = torch.from_numpy(r0.prompt[None]).cuda()
    with torch.inference_mode():
        lk, _ = model.prefill(params, {"tokens": toks}, max_len=2048)
        plain = Model(cfg, ParallelCtx(attn_impl="plain"), device="cuda")
        lp, _ = plain.prefill(params, {"tokens": toks}, max_len=2048)
    err = (lk - lp).abs().max().item()
    top2 = lp[0].topk(2).values
    first_equal = bool(lk.argmax() == lp.argmax()) \
        and int(lk.argmax()) == out[r0.id][0]
    log(f"[serve-ssm] request {r0.id} (S {toks.shape[1]}) prefill logits, "
        f"kernel vs plain: max_abs_err {err:.4g} (atol "
        f"{SSM_LOGIT_ATOL_BF16}), "
        f"logit std {lp.std().item():.3f}, top-2 gap "
        f"{(top2[0] - top2[1]).item():.4g}; first token equal to the "
        f"plain prefill's and the served one {first_equal}")
    if not (torch.isfinite(lk).all() and err <= SSM_LOGIT_ATOL_BF16
            and first_equal):
        raise AssertionError(f"mamba2 prefill: kernel vs plain err {err}, "
                             f"first token equal {first_equal}")

    # the same requests with adaptive lanes
    reqs2 = ssm_requests(cfg.vocab_size)
    srv2 = BatchServer(model, params, batch_lanes=4, max_len=2048,
                       adaptive_lanes=True)
    out2 = srv2.run(reqs2)
    agree = sum(a == b for r in reqs for a, b in zip(out[r.id], out2[r.id]))
    firsts = all(out[r.id][0] == out2[r.id][0] for r in reqs)
    log(f"[serve-ssm] adaptive_lanes: resizes {srv2.stats.resizes}, "
        f"lane_slots {srv2.stats.lane_slots} vs {st.lane_slots}; tokens "
        f"agreeing with the fixed pool {agree}/{total_new} "
        f"({agree / total_new:.3f}); first tokens equal {firsts}")
    if srv2.stats.lane_steps != total_new or not firsts:
        raise AssertionError("adaptive run: lane_steps or first tokens off")
    return model, params, r0.prompt


def profile_calls(calls) -> list:
    """For each (label, fn): the host-clock wall time of a warm call (median
    of 3, unprofiled), the sum of kernel durations in a torch.profiler trace
    of one call, the device's idle share (1 - kernels / wall), and the top
    kernels by device time. Returns (wall ms, {kernel: (ms, launches)}) per
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
        for e in device_events(fn, with_cpu=True):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        busy_ms = sum(ms for ms, _ in by_name.values())
        launches = sum(n for _, n in by_name.values())
        log(f"[profile] {label}: wall {wall_ms:.2f} ms (median of 3, "
            f"unprofiled), kernels {busy_ms:.2f} ms in {launches} "
            f"launches, device idle {1 - busy_ms / wall_ms:.3f}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        for name, (ms, n) in top:
            log(f"[profile]   {ms:8.3f} ms {ms / busy_ms:6.1%} x{n:<4d} "
                f"{name[:70]}")
        readings.append((wall_ms, by_name))
    return readings


def profile_serving(model, params, prompt: np.ndarray) -> None:
    """Device time by kernel and the device's idle share for one prefill of
    ``prompt`` and one 4-lane decode step of ``model`` (``profile_calls``)."""
    import torch
    from repro_torch.core import packing
    from repro_torch.launch.serve import LANE_AXIS
    toks = torch.from_numpy(prompt[None]).cuda()
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": toks}, max_len=2048)
        lane = packing.tree_get_lane(cache, 0, LANE_AXIS)
        pool = packing.stack_trees([lane] * 4, LANE_AXIS)
        step = {"tokens": torch.zeros((4, 1), dtype=torch.long,
                                      device="cuda"),
                "pos": torch.full((4,), toks.shape[1], device="cuda")}
        name = model.cfg.name
        calls = (
            (f"{name} prefill", lambda: model.prefill(
                params, {"tokens": toks}, max_len=2048)),
            (f"{name} decode", lambda: model.decode_step(params, step,
                                                         pool)))
        profile_calls(calls)


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


# kernel kinds by name: B3; the GEMMs (cuBLAS and CUTLASS names);
# reductions; copies, casts and layout changes; the rest elementwise
KERNEL_KINDS = (("B3", ("fa_fwd",)),
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


def log_remat_peaks(setting: str, peaks: dict) -> None:
    """Log ``lm_peaks``' readings with remat (``peaks[True]``) against
    without (``peaks[False]``)."""
    for name, what in (("held", "held from forward to backward"),
                       ("gradient", "gradient peak"),
                       ("pool step", "pool step peak")):
        (pt, dt), (pf, df) = peaks[True][name], peaks[False][name]
        log(f"[train-lm] {setting} {what}: {pt / 1e9:.3f} GB with remat "
            f"({dt / 1e9:.3f} above the pool), {pf / 1e9:.3f} GB without "
            f"({df / 1e9:.3f}); ratio {pt / pf:.3f} ({dt / df:.3f} above "
            f"the pool)")
    log(f"[train-lm] {setting}: left by a pool step for the garbage "
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
    busy = sum(ms for ms, _ in by_name.values())
    kinds: dict = {}
    for name, (ms, n) in by_name.items():
        kind = kernel_kind(name)
        kinds[kind] = tuple(a + b for a, b in zip(kinds.get(kind, (0, 0)),
                                                  (ms, n)))
    log("[profile] by kind: " + ", ".join(
        f"{kind} {ms:.2f} ms ({ms / busy:.1%}, x{n})" for kind, (ms, n) in
        sorted(kinds.items(), key=lambda kv: -kv[1][0])))
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


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
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
    card = setup()
    records = [check_flash_attention(), check_packed_gemm(), *check_rmsnorm(),
               check_ssd_scan()]
    check_mamba2_gradient()
    check_small_reference()
    profile_serving(*serve_full(records[0]))
    profile_serving(*serve_ssm(records[4]))
    t1 = time.perf_counter()
    lenet_pool, lenet_batch = train_lenet()
    kernel_args = train_kernel(records[1])
    profile_training(lenet_pool, lenet_batch, kernel_args)
    del lenet_pool, lenet_batch, kernel_args
    train_lm(records[0])
    log(f"[done] {time.perf_counter() - t0:.1f} s, training phases "
        f"{time.perf_counter() - t1:.1f} s")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
