#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py          # from the root of a repository checkout

Phases, in order; any failure propagates and the exit code is non-zero:

1. set-up: build every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once), print the card's name and power
   limit, turn TF32 off;
2. each kernel against its plain PyTorch version on the card, at the serving
   path's shape and at GQA / window / f32 / ragged / lane-masked cases, and
   timed beside its bound and the PyTorch library call;
3. a small reference: a narrow f32 model served on the card (kernel path)
   and on the CPU (chunked path) from the same parameters must agree;
4. the main path: ``BatchServer`` serving 8 requests on full-width
   StableLM-2 1.6B (random weights from a seed), with every kernel's launch
   count read around that run, then the same requests with
   ``adaptive_lanes``;
5. where the time goes: device time by kernel and the device's idle share
   for one prefill and one 4-lane decode step (torch.profiler).

The last three lines of standard output are the ``nvidia-smi`` name/power
line, a JSON object with one record per kernel, and the result line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
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
# plain version: 24 layers of bf16 rounding on both sides
LOGIT_ATOL_BF16 = 0.25
SMALL_LOGIT_ATOL_F32 = 1e-4

N_LAYERS_FULL = 24


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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[card] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

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
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
    for dt, D in ((bf16, 64), (f32, 128)):
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

    # timing at the serving path's prefill shape
    name, B, Sq, Sk, Hq, Hkv, D, dt, causal, window = cases[0]
    q, k, v = _qkv(gen, B, Sq, Sk, Hq, Hkv, D, dt)
    ms = cuda_time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    plain_ms = cuda_time_ms(
        lambda: fa.flash_attention_plain(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bound_ms, bound_by = attention_bound_ms(B, Sq, Sk, Hq, Hkv, D, causal,
                                            window, dt)
    log(f"[kernel] flash_attention {tuple(q.shape)} bf16 causal: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:159",
            "launches": None, "max_abs_err": errs["prefill"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phases 3-5: serving
# ---------------------------------------------------------------------------

def make_requests(seed: int, n: int, prompt_range, new_range, vocab: int):
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_range[0], prompt_range[1] + 1, n)
    news = rng.integers(new_range[0], new_range[1] + 1, n)
    return [Request(id=i, prompt=rng.integers(0, vocab, int(s)).astype(
        np.int64), max_new=int(m)) for i, (s, m) in enumerate(zip(lens, news))]


def check_small_reference() -> None:
    """A narrow f32 model (head_dim 64, so the kernel takes it) served on the
    card through the kernel and on the CPU through the chunked path, from
    the same parameters: prefill logits agree and tokens match."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(configs.get("stablelm-1.6b").reduced(),
                              d_model=256, num_heads=4, num_kv_heads=2,
                              head_dim=64)
    cpu_model = Model(cfg, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    gpu_model = Model(cfg, device="cuda")
    gpu_params = _tree_to(cpu_params, "cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 150)))
    lc, _ = cpu_model.prefill(cpu_params, {"tokens": toks}, max_len=192)
    lg, _ = gpu_model.prefill(gpu_params, {"tokens": toks.cuda()},
                              max_len=192)
    err = (lg.cpu() - lc).abs().max().item()
    log(f"[small] f32 prefill logits card (kernel) vs cpu (chunked): "
        f"max_abs_err {err:.3g} (atol {SMALL_LOGIT_ATOL_F32})")
    if not err <= SMALL_LOGIT_ATOL_F32:
        raise AssertionError(f"small reference: logits differ by {err}")
    outs = []
    for model, params in ((cpu_model, cpu_params), (gpu_model, gpu_params)):
        reqs = make_requests(2, 5, (40, 120), (2, 9), cfg.vocab_size)
        outs.append(BatchServer(model, params, batch_lanes=2,
                                max_len=160).run(reqs))
    if outs[0] != outs[1]:
        raise AssertionError("small reference: card and cpu tokens differ")
    log("[small] served 5 requests: card tokens == cpu tokens")


def serve_full(record: dict):
    """The main path; sets ``record["launches"]`` from its run. Returns
    (model, params, longest prompt) for the profile."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
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
    fa.flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    out = srv.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention_cuda.launches
    record["launches"] = launches
    st = srv.stats
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_tokens = st.lane_steps - st.prefills
    log(f"[serve] 8 requests, prompts {min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, max_new "
        f"{min(r.max_new for r in reqs)}-{max(r.max_new for r in reqs)}: "
        f"wall {wall:.3f} s, prefills {st.prefills}, global_steps "
        f"{st.global_steps}, lane_steps {st.lane_steps}, lane_slots "
        f"{st.lane_slots}, flash_attention launches {launches}")
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


def profile_serving(model, params, prompt: np.ndarray) -> None:
    """Device time by kernel and the device's idle share for one prefill of
    ``prompt`` and one 4-lane decode step, from a torch.profiler trace (the
    sum of kernel durations against the host clock around each call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
        calls = (
            ("prefill", lambda: model.prefill(params, {"tokens": toks},
                                              max_len=2048)),
            ("decode", lambda: model.decode_step(params, step, pool)))
        for label, fn in calls:
            walls = []
            for _ in range(4):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            wall_ms = float(np.median(walls[1:]))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            by_name: dict = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    ms, n = by_name.get(e.name, (0.0, 0))
                    by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                                       n + 1)
            busy_ms = sum(ms for ms, _ in by_name.values())
            launches = sum(n for _, n in by_name.values())
            log(f"[profile] {label}: wall {wall_ms:.2f} ms (median of 3, "
                f"unprofiled), kernels {busy_ms:.2f} ms in {launches} "
                f"launches, device idle {1 - busy_ms / wall_ms:.3f}")
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
            for name, (ms, n) in top:
                log(f"[profile]   {ms:8.3f} ms {ms / busy_ms:6.1%} x{n:<4d} "
                    f"{name[:70]}")


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
    record = check_flash_attention()
    check_small_reference()
    profile_serving(*serve_full(record))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
