"""The port's roofline (``repro_torch.roofline``) on the CPU.

  * The reference's ``tests/test_roofline_signal.py`` cases that build no
    JAX program, run again on the port by ``test_torch_policy_reference``'s
    rebinding (the reference's modules and classes become the port's). Three
    of its cases have the port's own versions here: the port's default
    ``HW`` is the H100 (the reference's is v5e, and it asserts that "h100"
    is unknown), and the matmul-against-add ordering builds a JAX program
    in the reference and a counted step here.
  * ``counting``: each kernel entry of ``kernels.ops`` and its plain version
    counted by its formula, once per call and under ``vmap`` for every
    lane; a model's forward counts the same through the kernel entry and
    through the plain version; a step counts the same on the CPU and on
    ``meta``; a reduced train step's FLOPs within 0.5-6x of 6·N·D (the
    reference's ``tests/test_integration.py`` bound for its HLO count).
  * ``analysis``: ``model_flops``, ``attn_kernel_io_bytes`` and the
    report's properties against the reference's on the same numbers
    (exact: the same float arithmetic), and profiles of a decode and a
    train step through ``TriplesScheduler.submit(intensity_profile=...)``.
"""
import dataclasses
import importlib
import inspect
import types

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.roofline import analysis as janalysis
from repro_torch import configs, optim
from repro_torch.core import packing
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_rmsnorm as rn
from repro_torch.kernels import ops
from repro_torch.kernels import packed_gemm as pg
from repro_torch.kernels import ssd_scan as sd
from repro_torch.launch.train import make_train_step
from repro_torch.models.model import Model
from repro_torch.models.transformer import ParallelCtx
from repro_torch.roofline import analysis, counting
from repro_torch.roofline.analysis import HW, IntensityProfile

import chip_smoke
import test_torch_policy_reference as rebind

# ---------------------------------------------------------------------------
# the reference's cases, rebound to the port
# ---------------------------------------------------------------------------

REF = "test_roofline_signal"
# the reference's cases that stay out, each with the reason and the port's
# own version below
OWN_VERSION = {
    "test_hw_for_arch_presets":
        "asserts HW() is v5e; the port's default is the H100",
    "test_hw_for_arch_unknown_raises": "asserts that 'h100' is unknown",
    "test_intensity_profile_from_compiled_decode_vs_train_ordering":
        "builds a JAX program",
}


def _ref_cases():
    mod = importlib.import_module(REF)
    return sorted(n for n, v in vars(mod).items()
                  if n.startswith("test_") and callable(v)
                  and n not in OWN_VERSION)


def test_reference_case_list_covers_the_file():
    mod = importlib.import_module(REF)
    names = {n for n, v in vars(mod).items()
             if n.startswith("test_") and callable(v)}
    assert names == set(_ref_cases()) | set(OWN_VERSION)
    assert len(_ref_cases()) == 5          # the reference file is frozen


@pytest.mark.parametrize("name", _ref_cases())
def test_reference_roofline_case_on_port(name):
    fn = getattr(rebind._rebound_module(importlib.import_module(REF)), name)
    g = fn.__globals__
    left = [k for k, v in g.items() if not k.startswith("__")
            and rebind._is_ref(v.__name__ if isinstance(v, types.ModuleType)
                               else getattr(v, "__module__", None) or "")]
    assert left == [], f"globals still bound to the reference: {left}"
    assert not inspect.signature(fn).parameters
    fn()


# ---------------------------------------------------------------------------
# the port's own versions of the three
# ---------------------------------------------------------------------------

def test_hw_presets_default_to_the_h100():
    """``HW()`` is the H100 preset, at the rates ``chip_smoke.py`` bounds
    its kernels with; the reference's four TPU presets are kept."""
    assert HW() == HW.for_arch("h100")
    assert HW().peak_flops == chip_smoke.PEAK_FLOPS["torch.bfloat16"]
    assert HW().hbm_bw == chip_smoke.PEAK_BYTES_S
    assert HW().hbm_bytes == 80e9
    for arch in ("v4", "v5e", "v5p", "v6e"):
        mine = dataclasses.asdict(HW.for_arch(arch))
        assert mine == dataclasses.asdict(janalysis.HW.for_arch(arch))
    for arch in ("v4", "v5e", "v5p", "v6e", "h100"):
        hw = HW.for_arch(arch)
        assert hw.peak_flops > 0 and hw.hbm_bw > 0
        assert hw.ici_bw > 0 and hw.hbm_bytes > 0


def test_hw_for_arch_unknown_raises_and_names_the_presets():
    with pytest.raises(ValueError, match="h100"):
        HW.for_arch("b200")


def test_intensity_profile_from_step_matmul_vs_add_ordering():
    """A bandwidth-bound step must score a larger memory_bound_frac than a
    compute-leaning one (the signal the planner consumes)."""
    a, b = torch.zeros((512, 512)), torch.zeros((512, 512))
    p_mm = IntensityProfile.from_step(lambda a, b: a @ b, a, b)
    p_ew = IntensityProfile.from_step(lambda a, b: a + b, a, b)
    assert p_ew.memory_bound_frac > p_mm.memory_bound_frac
    assert p_mm.arithmetic_intensity > p_ew.arithmetic_intensity
    # the matmul: 2·512³ FLOPs over three 512² f32 tensors
    assert p_mm.arithmetic_intensity == pytest.approx(
        2 * 512 ** 3 / (3 * 512 ** 2 * 4))
    assert p_ew.bottleneck == "memory" and p_ew.arithmetic_intensity == 0.0


# ---------------------------------------------------------------------------
# counting: the kernel leaves
# ---------------------------------------------------------------------------

def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _leaf_cases():
    """name -> (entry of ``kernels.ops``, (module, name) of its plain
    version, args, kwargs, formula (flops, bytes)). Both are looked up
    when called, as the model's code does, so the counting leaves apply."""
    B, S, Hq, Hkv, D = 2, 40, 4, 2, 16
    q, k, v = _rand(B, S, Hq, D), _rand(B, S, Hkv, D, seed=1), \
        _rand(B, S, Hkv, D, seed=2)
    b, Sx, nh, hd, N, Q = 2, 64, 4, 8, 16, 32
    x = _rand(b, Sx, nh, hd)
    dt = torch.nn.functional.softplus(_rand(b, Sx, nh, seed=3))
    A = -torch.exp(_rand(nh, seed=4))
    Bm, Cm = _rand(b, Sx, N, seed=5), _rand(b, Sx, N, seed=6)
    s0 = _rand(b, nh, hd, N, seed=7)
    J, M, K, Nn = 3, 8, 16, 12
    xs, ws = _rand(J, M, K), _rand(J, K, Nn, seed=8)
    xn, wn = _rand(J, 10, 24), _rand(J, 24, seed=9)
    f = counting
    return {
        "flash_causal": ("flash_attention", (fa, "flash_attention_plain"),
                         (q, k, v), dict(causal=True, window=0),
                         f.attention_work(B, S, S, Hq, Hkv, D, True, 0, 4)),
        "flash_window": ("flash_attention", (fa, "flash_attention_plain"),
                         (q, k, v), dict(causal=True, window=7),
                         f.attention_work(B, S, S, Hq, Hkv, D, True, 7, 4)),
        "flash_bidir": ("flash_attention", (fa, "flash_attention_plain"),
                        (q, k[:, :25], v[:, :25]), dict(causal=False),
                        f.attention_work(B, S, 25, Hq, Hkv, D, False, 0, 4)),
        "ssd": ("ssd", (sd, "ssd_scan_plain"), (x, dt, A, Bm, Cm),
                dict(chunk=Q), f.ssd_work(b, Sx, nh, hd, N, Q, 4)),
        "ssd_init_state": ("ssd", (sd, "ssd_scan_plain"), (x, dt, A, Bm, Cm),
                           dict(chunk=Q, init_state=s0),
                           f.ssd_work(b, Sx, nh, hd, N, Q, 4, True)),
        "packed_matmul": ("packed_matmul", (pg, "packed_gemm_plain"), (xs, ws),
                          {}, f.matmul_work(J, M, K, Nn, 4)),
        "packed_norm": ("packed_norm", (rn, "packed_rmsnorm_plain"), (xn, wn),
                        {}, f.norm_work(J * 10, 24, J, 4)),
    }


LEAF_CASES = _leaf_cases()


@pytest.mark.parametrize("route", ["ops", "plain"])
@pytest.mark.parametrize("case", sorted(LEAF_CASES))
def test_kernel_leaf_counted_by_its_formula(case, route):
    """Each ``kernels.ops`` entry, and its plain version called directly,
    counts its formula's FLOPs and bytes, once, and nothing of the ops it
    runs inside; the leaf's tag holds the same numbers."""
    entry, (mod, plain), args, kw, (flops, nbytes) = LEAF_CASES[case]
    owner, name = (ops, entry) if route == "ops" else (mod, plain)
    c = counting.count_step(lambda *a: getattr(owner, name)(*a, **kw), *args)
    assert (c.flops, c.bytes) == (flops, nbytes)
    assert c.leaf_calls == {name: 1}
    tag = "sdpa" if "flash" in case else case.split("_init")[0]
    assert (c.flops_by_tag, c.bytes_by_tag) == ({tag: flops}, {tag: nbytes})


@pytest.mark.parametrize("case", ["flash_causal", "packed_matmul",
                                  "packed_norm"])
def test_kernel_leaf_under_vmap_counts_every_lane(case):
    """Under ``torch.func.vmap`` a leaf reads its operands' physical
    shapes: three lanes count three times one lane's work."""
    entry, _, args, kw, (flops, nbytes) = LEAF_CASES[case]
    lanes = [torch.stack([a, a * 0.5, a + 1.0]) for a in args]
    c = counting.count_step(lambda *a: torch.func.vmap(
        lambda *t: getattr(ops, entry)(*t, **kw))(*a), *lanes)
    assert sum(c.flops_by_tag.values()) == 3 * flops
    assert sum(c.bytes_by_tag.values()) == 3 * nbytes


ARCHS = ["stablelm-1.6b", "mamba2-130m", "deepseek-moe-16b", "zamba2-7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_counts_the_same_through_kernel_and_plain(arch):
    """A prefill counts the same FLOPs and bytes whether its sequence
    mixers go through ``kernels.ops`` (impl="kernel") or call the plain
    versions (impl="plain"), and more through the reference's own chunked
    paths, which are no leaves."""
    cfg = configs.get(arch).reduced()
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64)))
    got = {}
    for impl in ("kernel", "plain", "chunked"):
        m = Model(cfg, ParallelCtx(attn_impl=impl), device="cpu")
        p = m.init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            got[impl] = counting.count_step(
                lambda p, t: m.prefill(p, {"tokens": t}, 72), p, toks)
    k, pl, ch = got["kernel"], got["plain"], got["chunked"]
    assert (k.flops, k.bytes, k.bytes_by_tag) == (pl.flops, pl.bytes,
                                                  pl.bytes_by_tag)
    assert sum(k.leaf_calls.values()) == sum(pl.leaf_calls.values()) > 0
    assert ch.leaf_calls == {} and ch.bytes > k.bytes


def _tree_to(trees: tuple, device) -> tuple:
    return tuple(packing.tree_map(lambda t: t.to(device), t) for t in trees)


def _lanes(model, k, S=32, seed=0):
    opt = optim.adamw()
    ps = packing.stack_trees([model.init(torch.Generator().manual_seed(s))
                              for s in range(k)])
    os_ = packing.stack_trees([opt.init(packing.lane_slice(ps, i))
                               for i in range(k)])
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, model.cfg.vocab_size, (k, 2, S + 1)))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    return opt, (ps, os_, batch, torch.full((k,), 1e-3))


@pytest.mark.parametrize("arch", ARCHS)
def test_step_counts_the_same_on_cpu_and_meta(arch):
    """A 2-lane training step (``packed_step`` of ``make_train_step``,
    remat on) and a decode step count equal FLOPs and bytes on the CPU and
    on ``meta`` tensors of the same shapes: the card's count is held to
    the meta count the same way by ``chip_smoke.py``."""
    cfg = dataclasses.replace(configs.get(arch).reduced(), remat=True)
    model = Model(cfg, ParallelCtx(attn_impl="kernel"
                                   if arch != "zamba2-7b" else None),
                  device="cpu")
    opt, args = _lanes(model, 2)
    step = packing.packed_step(make_train_step(model, opt))
    cpu = counting.count_step(step, *args)
    meta = counting.count_step(step, *_tree_to(args, "meta"))
    assert (cpu.flops, cpu.bytes, cpu.leaf_calls) == (
        meta.flops, meta.bytes, meta.leaf_calls)
    p = packing.tree_get_lane(args[0], 0)
    toks = args[2]["tokens"][0]
    with torch.no_grad():
        _, cache = model.prefill(p, {"tokens": toks}, max_len=40)
        b = {"tokens": toks[:, :1], "pos": torch.full((2,), 32)}

        def decode(p, b, c):
            return model.decode_step(p, b, c, route_rows=True)
        cpu = counting.count_step(decode, p, b, cache)
        meta = counting.count_step(decode, *_tree_to((p, b, cache), "meta"))
    assert (cpu.flops, cpu.bytes) == (meta.flops, meta.bytes)
    assert cpu.flops > 0 and cpu.bytes > 0


def test_remat_recompute_is_counted():
    """Remat's recompute runs the forward again inside the backward: the
    flash-attention leaf is called twice a layer instead of once, and the
    step counts more FLOPs."""
    cfg = configs.get("deepseek-moe-16b").reduced()
    c = {}
    for remat in (False, True):
        model = Model(dataclasses.replace(cfg, remat=remat),
                      ParallelCtx(attn_impl="kernel"), device="cpu")
        opt, args = _lanes(model, 2)
        c[remat] = counting.count_step(
            packing.packed_step(make_train_step(model, opt)), *args)
    L = cfg.num_layers
    assert c[False].leaf_calls == {"flash_attention": L}
    assert c[True].leaf_calls == {"flash_attention": 2 * L}
    assert c[True].flops > c[False].flops


def test_model_flops_ratio_sane_for_tiny_train_step():
    """The port's version of the reference's
    ``tests/test_integration.py::test_model_flops_ratio_sane_for_tiny_train_step``:
    the counted FLOPs of a reduced train step are 6·N·D within a small
    factor (remat and the causal chunks' overhead)."""
    cfg = dataclasses.replace(configs.get("stablelm-1.6b").reduced(),
                              remat=False, vocab_size=256)
    model = Model(cfg, ParallelCtx(moe_oracle=True), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = optim.sgd()
    B, S = 4, 64
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32),
             "labels": torch.zeros((B, S), dtype=torch.int32)}
    c = counting.count_step(make_train_step(model, opt), params,
                            opt.init(params), batch, torch.tensor(1e-3))
    ratio = c.flops / (6 * cfg.param_count() * B * S)
    assert 0.5 < ratio < 6.0, ratio


# ---------------------------------------------------------------------------
# analysis against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_params,n_tokens,kind", [
    (1.6e9, 4096, "train"), (1.6e9, 4, "decode"), (3e6, 128, "prefill")])
def test_model_flops_matches_reference(n_params, n_tokens, kind):
    assert analysis.model_flops(n_params, n_tokens, kind) == \
        janalysis.model_flops(n_params, n_tokens, kind)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-130m",
                                  "zamba2-7b", "deepseek-moe-16b",
                                  "seamless-m4t-medium"])
def test_attn_kernel_io_bytes_matches_reference(arch, kind):
    """The tensor- and data-parallel sizes as integers against the
    reference's mesh of the same sizes."""
    for tp, dp in ((1, 1), (2, 4)):
        mesh = types.SimpleNamespace(shape={"model": tp}, size=tp * dp)
        want = janalysis.attn_kernel_io_bytes(jconfigs.get(arch), 8192,
                                              mesh, kind)
        got = analysis.attn_kernel_io_bytes(configs.get(arch), 8192, tp, dp,
                                            kind)
        assert got == want and got > 0


REPORTS = [
    dict(flops_per_dev=3.2e12, bytes_per_dev=4.1e10),    # memory-bound
    dict(flops_per_dev=9.0e14, bytes_per_dev=2.0e9),     # compute-bound
    dict(flops_per_dev=0.0, bytes_per_dev=0.0),          # empty
]


@pytest.mark.parametrize("arch", ["v5e", "h100"])
@pytest.mark.parametrize("case", range(len(REPORTS)))
def test_report_properties_match_reference(case, arch):
    """On the same numbers the port's report gives the reference's terms,
    bottleneck, fractions, kernel-substituted memory term and row (whose
    ``hlo_gflops_dev`` is the port's ``gflops_dev``)."""
    kw = dict(arch=arch, shape="train_4k", mesh="1", chips=1,
              coll_operand_bytes=0, coll_traffic_bytes=0, coll_by_kind={},
              peak_mem_bytes=7 * 10 ** 9, arg_bytes=10 ** 9,
              model_flops_global=2.5e12, bytes_by_tag={"sdpa": 1e8},
              kernel_io_bytes=4e7, **REPORTS[case])
    hw = HW.for_arch(arch)
    mine = analysis.RooflineReport(hw=hw, **kw)
    ref = janalysis.RooflineReport(hw=janalysis.HW(**dataclasses.asdict(hw)),
                                   **kw)
    for name in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "t_bound", "flops_global", "useful_flops_ratio",
                 "roofline_fraction", "bytes_per_dev_kernel",
                 "t_memory_kernel", "t_bound_kernel",
                 "roofline_fraction_kernel"):
        assert getattr(mine, name) == getattr(ref, name), name
    want = ref.row()
    want["gflops_dev"] = want.pop("hlo_gflops_dev")
    assert mine.row() == want
    assert IntensityProfile.from_report(mine) == IntensityProfile(
        **dataclasses.asdict(janalysis.IntensityProfile.from_report(ref)))


def test_analyze_step_reports_a_counted_train_step():
    """``analyze_step`` of a reduced moe train step through the kernel
    entry: the counts, the leaf bytes under "sdpa" (so the
    kernel-substituted term is the counted one), 6·N·D and the profile."""
    cfg = dataclasses.replace(configs.get("deepseek-moe-16b").reduced(),
                              remat=True)
    model = Model(cfg, ParallelCtx(attn_impl="kernel"), device="cpu")
    opt, args = _lanes(model, 2)
    step = packing.packed_step(make_train_step(model, opt))
    c = counting.count_step(step, *args)
    r = analysis.analyze_step(step, *args, arch="h100", shape="2x2x32",
                              n_params=cfg.param_count(), n_tokens=128,
                              kind="train")
    assert (r.flops_per_dev, r.bytes_per_dev) == (c.flops, c.bytes)
    assert r.bytes_by_tag == c.bytes_by_tag and r.bytes_by_tag["sdpa"] > 0
    assert r.bytes_per_dev_kernel == r.bytes_per_dev
    assert r.model_flops_global == 6.0 * cfg.param_count() * 128
    assert r.peak_mem_bytes == 0 and r.arg_bytes == counting._tensor_bytes(
        args)
    assert r.t_collective == 0.0 and r.chips == 1
    assert set(r.row()) == {
        "arch", "shape", "mesh", "chips", "t_compute_s", "t_memory_s",
        "t_collective_s", "bottleneck", "gflops_dev", "hbm_gb_dev",
        "coll_gb_dev", "peak_mem_gb_dev", "model_gflops_global",
        "useful_flops_ratio", "roofline_fraction"}
    p = IntensityProfile.from_step(step, *args)
    assert p == IntensityProfile.from_report(r)


def test_profiles_of_decode_and_train_feed_the_scheduler():
    """A 4-lane decode step and a 2-lane train step of the reduced models,
    profiled by ``from_step``, go to a ``TriplesScheduler`` through
    ``submit(intensity_profile=...)``; admission records each under
    ``kind:<kind>`` at first dispatch (``chip_smoke.schedule_profiles``,
    which ``[roofline]`` runs on the card). The decode step is the more
    memory-bound."""
    dense = Model(configs.get("stablelm-1.6b").reduced(), device="cpu")
    p = dense.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 32)))
    with torch.no_grad():
        _, cache = dense.prefill(p, {"tokens": toks}, max_len=40)
        decode = IntensityProfile.from_step(
            lambda p, b, c: dense.decode_step(p, b, c, route_rows=True), p,
            {"tokens": toks[:, :1], "pos": torch.full((4,), 32)}, cache)
    cfg = dataclasses.replace(configs.get("deepseek-moe-16b").reduced(),
                              remat=True, d_model=128, d_ff=256)
    moe = Model(cfg, ParallelCtx(attn_impl="kernel"), device="cpu")
    opt, args = _lanes(moe, 2, S=64)
    train = IntensityProfile.from_step(
        packing.packed_step(make_train_step(moe, opt)), *args)
    assert decode.memory_bound_frac > train.memory_bound_frac
    recorded = chip_smoke.schedule_profiles({"decode": decode,
                                             "train": train}, hbm=80e9)
    assert recorded == {"decode": decode.interference,
                        "train": train.interference}


def test_counting_restores_the_kernel_entries_and_meta_still_raises():
    """After a count, even one whose step raised, ``kernels.ops`` and the
    kernel modules hold their own functions again, and a kernel wrapper
    given meta tensors outside a count raises as before."""
    before = {m: dict(vars(m)) for m in (ops, fa, sd, pg, rn)}
    with pytest.raises(RuntimeError, match="inside"):
        counting.count_step(lambda: (_ for _ in ()).throw(
            RuntimeError("inside")))
    entry, _, args, kw, _ = LEAF_CASES["flash_causal"]
    counting.count_step(lambda *a: ops.flash_attention(*a, **kw),
                        *_tree_to(args, "meta"))
    for m, names in before.items():
        assert {k: v for k, v in vars(m).items() if callable(v)} == {
            k: v for k, v in names.items() if callable(v)}
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_fwd(*_tree_to(args, "meta"))


@pytest.mark.parametrize("route", ["ops", "plain"])
def test_leaves_return_the_kernels_contiguous_layout(route):
    """Within a count, flash attention's plain version returns its output
    contiguous, as the kernel writes it (outside a count it does not), so
    the reshape that follows is a view whichever version ran and the CPU,
    ``meta`` and the card count the same ops after the leaf."""
    _, (mod, plain), args, kw, _ = LEAF_CASES["flash_causal"]
    fn = (lambda *a: ops.flash_attention(*a, **kw)) if route == "ops" else (
        lambda *a: getattr(mod, plain)(*a, **kw))
    assert not fa.flash_attention_plain(*args, **kw).is_contiguous()
    seen = []
    for dev in ("cpu", "meta"):
        counting.count_step(lambda *a: seen.append(fn(*a).is_contiguous()),
                            *_tree_to(args, dev))
    assert seen == [True, True]
