"""The port's contract lint (``repro_torch.analysis``) against the
reference's (``repro.analysis``), and its CUDA half on the port's kernels.

  * parity: the port's DET, ACC and MASK rules over the reference's
    fixtures give the reference's findings, and both packages' decision
    modules come out clean under their own rules;
  * CUD fixture pairs under tests/fixtures/lint_torch/ (each bad fixture
    gives its exact count of its own rule only, each good twin is clean),
    and MASK201's positional forward;
  * ``//`` pragmas, LNT001/LNT002 on CUDA sources, the baseline;
  * seeded violations on copies of the real kernels and the port's
    scheduler, through the CLI;
  * the repo-wide gate, the static kernel report, and ``--libs``' parse of
    a ``cuobjdump --dump-resource-usage`` listing written by hand.
"""
import json
import re
import shutil
from pathlib import Path

import pytest

from repro.analysis import config as jconfig
from repro.analysis.core import SourceModule as JSourceModule
from repro.analysis.core import all_rule_ids as j_all_rule_ids
from repro.analysis.core import run_rules as j_run_rules
from repro.analysis.driver import collect_files as j_collect_files
from repro_torch.analysis import baseline as bl
from repro_torch.analysis import cuda_model as cm
from repro_torch.analysis import kernel_report as kr
from repro_torch.analysis import lint as lint_cli
from repro_torch.analysis.config import (DECISION_MODULES, LintConfig,
                                         default_config)
from repro_torch.analysis.core import (SourceModule, all_rule_ids,
                                       parse_pragmas, run_rules)
from repro_torch.analysis.driver import collect_files, run_lint
from repro_torch.analysis.rules_mask import _honors_active
from tests.test_analysis import fixture_config as j_fixture_config
from tests.test_torch_ssd import _layout, layout  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]
FIXDIR = ROOT / "tests" / "fixtures" / "lint_torch"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

#: The one wording the port changes in a copied message: the parenthesis
#: after "per-lane predicate" in MASK201's (the port names the contract,
#: the reference where it came from).
_PARENTHESIS = re.compile(r"\(per-lane predicate; [^)]*\)")
FAMILIES = ("DET", "ACC", "MASK")


def _rows(findings, families=FAMILIES):
    return [(f.rule, f.path, f.line, f.context, f.message)
            for f in findings if f.rule.startswith(families)]


def _edited(rows):
    return [(rule, path, line, ctx,
             _PARENTHESIS.sub("(per-lane predicate)", msg))
            for rule, path, line, ctx, msg in rows]


def _port_ref_config():
    """The reference fixtures' config, for the port's rules."""
    ref = j_fixture_config()
    return LintConfig(root=ref.root, paths=ref.paths,
                      decision_modules=ref.decision_modules,
                      mask_entrypoints=dict(ref.mask_entrypoints),
                      mask_dispatch=dict(ref.mask_dispatch),
                      acc_modules=ref.acc_modules, masked_kernels={},
                      fixed_order_sources=(), kernel_budgets={})


@pytest.fixture(scope="module")
def ref_fixture_runs():
    jc = j_fixture_config()
    jknown = j_all_rule_ids()
    jmods = [JSourceModule.load(p, jc.root, jknown)
             for p in j_collect_files(jc)]
    jactive, jsup, _ = j_run_rules(jmods, jc)
    pc = _port_ref_config()
    known = all_rule_ids()
    mods = [SourceModule.load(p, pc.root, known) for p in collect_files(pc)]
    active, sup, _ = run_rules(mods, pc)
    return (jactive, jsup), (active, sup)


def test_det_acc_mask_match_the_reference_on_its_fixtures(ref_fixture_runs):
    (jactive, jsup), (active, sup) = ref_fixture_runs
    want = _edited(_rows(jactive))
    assert want, "the reference's fixtures give findings"
    assert _edited(_rows(active)) == want
    assert _edited(_rows(sup)) == _edited(_rows(jsup))
    assert any("the lane-mask contract" in r[4] for r in _rows(active))
    for rule in ("DET001", "DET002", "DET003", "DET004", "DET005", "DET006",
                 "ACC301", "MASK201", "MASK202"):
        assert any(r[0] == rule for r in want), rule


def test_pragma_fixtures_match_the_reference(ref_fixture_runs):
    """LNT findings on the reference's pragma fixtures (which name DET
    rules only) are the reference's too."""
    (jactive, _), (active, _) = ref_fixture_runs
    pragma = lambda rows: [r for r in rows if r[1].startswith("pragma")]
    assert pragma(_rows(active, ("DET", "LNT"))) == \
        pragma(_rows(jactive, ("DET", "LNT")))


@pytest.mark.parametrize("family", ["ref", "port"])
def test_decision_modules_are_clean(family):
    """The reference's DET rules over ``src/repro/core``'s nine decision
    modules, and the port's over its copies, find nothing."""
    if family == "ref":
        from repro.analysis.driver import run_lint as j_run_lint
        cfg = jconfig.default_config(paths=jconfig.DECISION_MODULES)
        result = j_run_lint(cfg)
        n = len(jconfig.DECISION_MODULES)
    else:
        cfg = default_config(paths=DECISION_MODULES)
        result = run_lint(cfg)
        n = len(DECISION_MODULES)
    assert len(result.modules) == n == 9
    assert [f.render() for f in result.active] == []


def test_monitor_telemetry_reads_carry_their_pragmas():
    """C21: the port's RunMonitor reads the clock for step-time telemetry
    under the reference's DET001 pragma, with the reference's reason."""
    cfg = default_config(paths=("src/repro_torch/core/monitor.py",))
    result = run_lint(cfg)
    assert result.active == []
    assert [(f.rule, f.context) for f in result.suppressed] == [
        ("DET001", "RunMonitor.start_step"),
        ("DET001", "RunMonitor.end_step")]
    ref = (ROOT / "src/repro/core/monitor.py").read_text().splitlines()
    port = (ROOT / "src/repro_torch/core/monitor.py").read_text().splitlines()
    pragma = lambda lines: [ln.split("#", 1)[1] for ln in lines
                            if "lint: disable=DET001" in ln]
    assert pragma(port) == pragma(ref) and len(pragma(ref)) == 2


def test_mask201_takes_a_positional_forward():
    """C21: ``_FlashAttention.apply(..., _lane_predicate(active, q), ...)``
    forwards the mask; a parameter read only otherwise does not."""
    import ast
    src = (ROOT / "src/repro_torch/kernels/ops.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef)
              and n.name == "flash_attention")
    assert _honors_active(fn)
    for body, want in (("return f(x, active)", True),
                       ("return g(h(active, x))", True),
                       ("mask = active\n    return x", False),
                       ("return x * active", False),
                       ("return x", False)):
        fn = ast.parse(f"def e(x, active=None):\n    {body}\n").body[0]
        assert _honors_active(fn) is want, body


# ---------------------------------------------------------------------------
# the port's fixtures
# ---------------------------------------------------------------------------

FIXTURE_CU = sorted(p.name for p in FIXDIR.glob("*.cu"))

#: Budgets for every fixture kernel: cud406_bad mis-registers
#: ``tiled_kernel`` and omits ``no_budget_kernel``; everything else
#: matches its modelled bytes so the fixtures stay rule-pure.
FIXTURE_BUDGETS = {
    f"{name}::{kernel}": dict(smem_bytes=0, nominal={})
    for name, kernel in [
        ("cud401_bad.cu", "scale_kernel"), ("cud401_good.cu", "scale_kernel"),
        ("cud401_good.cu", "copy_kernel"),
        ("cud403_bad.cu", "late_gate_kernel"),
        ("cud403_bad.cu", "no_gate_kernel"),
        ("cud403_bad.cu", "no_exit_kernel"),
        ("cud403_good.cu", "late_gate_kernel"),
        ("cud403_good.cu", "no_gate_kernel"),
        ("cud403_good.cu", "no_exit_kernel"),
        ("cud404_bad.cu", "two_out_kernel"), ("cud404_bad.cu", "ones_kernel"),
        ("cud404_good.cu", "two_out_kernel"),
        ("cud404_good.cu", "ones_kernel"),
        ("cud405_bad.cu", "sum_kernel"), ("cud405_good.cu", "sum_kernel"),
        ("pragma_ok.cu", "hist_kernel"), ("pragma_bad.cu", "hist_kernel")]}
FIXTURE_BUDGETS["cud406_bad.cu::tiled_kernel"] = dict(smem_bytes=4096,
                                                     nominal={})
FIXTURE_BUDGETS["cud406_good.cu::tiled_kernel"] = dict(
    smem_bytes=16896 + 8192, nominal={"D": 64})

MASKED = {
    "cud403_bad.cu": {"late_gate_kernel": ("o",), "no_gate_kernel": ("o",),
                      "no_exit_kernel": ("o",)},
    "cud403_good.cu": {"late_gate_kernel": ("o",), "no_gate_kernel": ("o",),
                       "no_exit_kernel": ("o",)},
    "cud404_bad.cu": {"two_out_kernel": ("o", "st"), "ones_kernel": ("o",)},
    "cud404_good.cu": {"two_out_kernel": ("o", "st"), "ones_kernel": ("o",)},
}

POSITIONAL = ("packed_unused", "packed_assigned", "packed_expression")


def fixture_config(**overrides):
    base = dict(
        root=str(FIXDIR), paths=(".",), decision_modules=(),
        mask_entrypoints={"mask201_positional_bad.py": POSITIONAL,
                          "mask201_positional_good.py": POSITIONAL},
        mask_dispatch={}, acc_modules=(), masked_kernels=MASKED,
        fixed_order_sources=tuple(FIXTURE_CU),
        kernel_budgets=FIXTURE_BUDGETS)
    base.update(overrides)
    return LintConfig(**base)


@pytest.fixture(scope="module")
def fixture_findings():
    cfg = fixture_config()
    mods = [SourceModule.load(p, cfg.root, all_rule_ids())
            for p in collect_files(cfg)]
    active, suppressed, _ = run_rules(mods, cfg)
    return active, suppressed


def of(findings, rule=None, path=None):
    return [f for f in findings if (rule is None or f.rule == rule)
            and (path is None or f.path == path)]


RULE_CASES = [
    ("CUD401", "cud401_bad.cu", 2, "cud401_good.cu"),
    ("CUD403", "cud403_bad.cu", 3, "cud403_good.cu"),
    ("CUD404", "cud404_bad.cu", 2, "cud404_good.cu"),
    ("CUD405", "cud405_bad.cu", 2, "cud405_good.cu"),
    ("CUD406", "cud406_bad.cu", 2, "cud406_good.cu"),
    ("MASK201", "mask201_positional_bad.py", 3,
     "mask201_positional_good.py"),
]


@pytest.mark.parametrize("rule,bad,expected,good", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_rule_fixture_pair(fixture_findings, rule, bad, expected, good):
    active, _ = fixture_findings
    hits = of(active, rule=rule, path=bad)
    assert len(hits) == expected, [f.render() for f in of(active, path=bad)]
    assert of(active, path=bad) == hits           # rule-pure
    assert of(active, path=good) == [], [f.render()
                                         for f in of(active, path=good)]


def test_cuda_pragma_suppresses_with_reason(fixture_findings):
    active, suppressed = fixture_findings
    assert of(active, path="pragma_ok.cu") == []
    assert [f.rule for f in of(suppressed, path="pragma_ok.cu")] == [
        "CUD405"]


def test_cuda_pragma_empty_reason_and_unused(fixture_findings):
    active, _ = fixture_findings
    hits = of(active, path="pragma_bad.cu")
    assert sorted(f.rule for f in hits) == ["CUD405", "LNT001", "LNT002"]
    lnt1 = of(hits, rule="LNT001")[0]
    assert "// lint: disable=RULE(reason)" in lnt1.message
    assert "CUD405" in of(hits, rule="LNT002")[0].message


def test_cuda_pragmas_parse_from_comments_only():
    src = ('// lint: disable=CUD405(a reason)\n'
           'const char* s = "// lint: disable=CUD401(in a string)";\n'
           '/* lint: disable=CUD403(a block comment) */\n')
    comments = cm.strip_source(src)[1]
    pragmas, malformed = parse_pragmas(src, all_rule_ids(),
                                       comments=comments)
    assert [(p.line, p.rule) for p in pragmas] == [(1, "CUD405")]
    assert malformed == []


def test_cuda_kernel_model_reads_the_fixture():
    src = cm.load(str(FIXDIR / "cud403_bad.cu"), "cud403_bad.cu")
    k = {k.name: k for k in src.kernels}
    late = k["late_gate_kernel"]
    assert late.block_axes == ("x", "y")
    assert (late.first_load_line, late.gate_line) == (16, 17)
    assert late.gate_exits and not late.gated_before_load
    assert [ln.grid_rank for ln in late.launches] == [2]


def test_baseline_roundtrip_and_drift(tmp_path, fixture_findings):
    active, _ = fixture_findings
    path = str(tmp_path / "bl.json")
    bl.save_baseline(path, active)
    assert bl.load_baseline(path) == bl.count_findings(active)
    assert bl.diff_baseline(active, bl.load_baseline(path)) == ([], [])
    bl.save_baseline(path, active[1:])
    new, stale = bl.diff_baseline(active, bl.load_baseline(path))
    assert [f.fingerprint for f in new] == [active[0].fingerprint]
    bl.save_baseline(path, active)
    new, stale = bl.diff_baseline(active[1:], bl.load_baseline(path))
    assert new == [] and stale == [active[0].fingerprint]


# ---------------------------------------------------------------------------
# seeded violations on copies of the real sources
# ---------------------------------------------------------------------------

def _port_tree(tmp_path, edits=(), files=("kernels/csrc",)):
    """A copy of the port's files under ``tmp_path``, with each
    ``(relpath under src/repro_torch, old, new)`` edit applied once."""
    dst_pkg = tmp_path / "src" / "repro_torch"
    for rel in files:
        src = ROOT / "src" / "repro_torch" / rel
        if src.is_dir():
            shutil.copytree(src, dst_pkg / rel)
        else:
            (dst_pkg / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, dst_pkg / rel)
    for rel, old, new in edits:
        path = dst_pkg / rel
        text = path.read_text()
        assert old in text, (rel, old)
        path.write_text(text.replace(old, new, 1))
    return tmp_path


_RMS_GATE = """  if (active != nullptr && active[j] == 0) {
    zero_row<T>(o + off, d);
    return;
  }
  norm_row<T, VPL>(x + off, w + (long long)j * d, o + off, d, eps);
"""

SEEDS = {
    "unmutated": ([], None),
    "CUD403": ([("kernels/csrc/rmsnorm.cu", _RMS_GATE,
                 "  norm_row<T, VPL>(x + off, w + (long long)j * d, o + off, "
                 "d, eps);\n" + _RMS_GATE.rsplit("  norm_row", 1)[0])],
               "CUD403"),
    "CUD405": ([("kernels/csrc/packed_gemm.cu", "  float acc[TM][TN];\n",
                 "  atomicAdd(o, 0.f);\n  float acc[TM][TN];\n")], "CUD405"),
    "CUD406": ([("kernels/csrc/flash_attention.cu",
                 "constexpr int BQ = 64;", "constexpr int BQ = 128;")],
               "CUD406"),
    "CUD401": ([("kernels/csrc/rmsnorm.cu", "  const int j = blockIdx.y;",
                 "  const int j = blockIdx.z;")], "CUD401"),
}


@pytest.mark.parametrize("seed", list(SEEDS))
def test_cli_seeded_kernel_violation(tmp_path, capsys, seed):
    edits, rule = SEEDS[seed]
    root = _port_tree(tmp_path, edits)
    rc = lint_cli.main(["--root", str(root), "--check"])
    out = capsys.readouterr().out
    if rule is None:
        assert rc == 0, out
        return
    assert rc == 1, out
    rules = {line.split(": ", 1)[1].split("[", 1)[0]
             for line in out.splitlines() if ".cu:" in line}
    assert rules == {rule}, out


def test_cli_seeded_wall_clock_in_scheduler(tmp_path, capsys):
    root = _port_tree(tmp_path, files=("core/scheduler.py",))
    path = root / "src" / "repro_torch" / "core" / "scheduler.py"
    assert lint_cli.main(["--root", str(root), "--check"]) == 0
    capsys.readouterr()
    path.write_text(path.read_text()
                    + "\n\ndef _seeded():\n    return time.time()\n")
    rc = lint_cli.main(["--root", str(root), "--check"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "DET001" in out and "scheduler.py" in out and "DET002" not in out


def test_cli_list_rules_names_the_omissions(capsys):
    assert lint_cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ("DET001", "MASK201", "ACC301", "CUD401", "CUD403", "CUD404",
                "CUD405", "CUD406", "JAX101", "JAX102", "JAX103", "PAL402"):
        assert rid in out
    not_ported = [ln for ln in out.splitlines() if "(not ported)" in ln]
    assert sorted(ln.split()[0] for ln in not_ported) == [
        "JAX101", "JAX102", "JAX103", "PAL402"]


# ---------------------------------------------------------------------------
# the repository itself
# ---------------------------------------------------------------------------

KERNELS = {"fa_fwd_simt_kernel", "fa_fwd_wgmma_kernel", "gemm_simt_kernel",
           "gemm_wgmma_kernel", "fused_rmsnorm_kernel",
           "packed_rmsnorm_kernel", "ssd_chunk_kernel", "ssd_state_kernel",
           "ssd_out_kernel"}


def test_repo_wide_lint_is_clean_against_an_empty_baseline(capsys):
    cfg = default_config()
    assert bl.load_baseline(cfg.abs_baseline()) == {}
    assert json.loads(Path(cfg.abs_baseline()).read_text()) == {
        "findings": {}, "version": 1}
    result = run_lint(cfg)
    assert result.ok and result.active == [], [f.render()
                                               for f in result.active]
    assert any(m.relpath.endswith(".cu") for m in result.modules)
    assert lint_cli.main(["--check"]) == 0
    assert "clean" in capsys.readouterr().out


def test_repo_config_names_real_files_and_kernels():
    cfg = default_config()
    for rel in (cfg.decision_modules + cfg.acc_modules
                + tuple(cfg.mask_entrypoints) + tuple(cfg.masked_kernels)
                + cfg.fixed_order_sources + (cfg.mask_dispatch["module"],)):
        assert (ROOT / rel).exists(), rel
    names = set()
    for src in kr.load_sources(cfg):
        names |= {f"{src.relpath}::{k.name}" for k in src.kernels}
        for name in cfg.masked_kernels.get(src.relpath, {}):
            assert name in {k.name for k in src.kernels}, name
    assert names == set(cfg.kernel_budgets)


def test_kernel_report_lists_the_nine_kernels_gated(capsys):
    rep = kr.build_report(default_config())
    assert {k["kernel"] for k in rep["kernels"]} == KERNELS
    assert rep["n_kernels"] == 9 and rep["n_masked"] == 8
    for k in rep["kernels"]:
        assert k["smem_bytes"] == k["smem_budget"], k
        assert k["atomics"] == 0 and all(
            ln["grid_rank"] >= len(k["block_axes"]) for ln in k["launches"])
        if k["masked"]:
            assert k["lane_predicate"] and k["gated_before_load"], k
    assert {k["kernel"] for k in rep["kernels"] if not k["masked"]} == {
        "fused_rmsnorm_kernel"}
    assert kr.main(["--check"]) == 0
    out = capsys.readouterr().out
    assert "9 kernel(s)" in out and "clean" in out


def test_kernel_report_json_is_deterministic(tmp_path, capsys):
    out = tmp_path / "rep.json"
    assert kr.main(["--json", "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    assert json.loads(printed) == json.loads(out.read_text())
    assert kr.main(["--json"]) == 0
    assert capsys.readouterr().out == printed


@pytest.mark.parametrize("shape", [
    (1, 1024, 24, 64, 128, 128, "bfloat16"),
    (1, 1024, 112, 64, 64, 128, "bfloat16"),
    (2, 256, 8, 16, 16, 32, "float32")])
def test_ssd_plan_shared_memory_matches_the_host_compiler(layout, shape):
    """The evaluator's shared memory of B4's chunk and output kernels (the
    launch's ``pl.chunk_smem``/``pl.out_smem`` through ``make_plan``) equals
    what ``csrc/ssd_plan.cuh`` computes when the host compiler builds it."""
    import torch
    b, S, nh, hd, N, Q, dtype = shape
    P, T = (1, "__nv_bfloat16") if dtype == "bfloat16" else (3, "float")
    want = _layout(layout, b, S, nh, hd, N, Q, getattr(torch, dtype))
    src = cm.load(str(CSRC / "ssd_scan.cu"), "ssd_scan.cu")
    k = {k.name: k for k in src.kernels}
    nominal = {"T": T, "P": P,
               "pl": f"make_plan({b}, {S}, {nh}, {hd}, {N}, {Q}, {P})"}
    assert src.shared_bytes(k["ssd_chunk_kernel"], nominal) == \
        want["smem"]["chunk"]
    assert src.shared_bytes(k["ssd_out_kernel"], nominal) == \
        want["smem"]["out"]


# ---------------------------------------------------------------------------
# --libs
# ---------------------------------------------------------------------------

_MANGLED = {
    "_Z8k_simt": "void simt::gemm_simt_kernel<simt::Tile<128, 64, 8, 4> >"
                 "(simt::Params)",
    # cu++filt's spelling of the anonymous namespace and of an int argument
    "_Z7k_wg0": "void <unnamed>::wg::gemm_wgmma_kernel<(int)0>("
                "CUtensorMap_st, CUtensorMap_st, <unnamed>::wg::Params)",
}

_USAGE = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _Z8k_simt:
  REG:151 STACK:0 SHARED:26624 LOCAL:0 CONSTANT[0]:600 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z7k_wg0:
  REG:170 STACK:16 SHARED:1024 LOCAL:16 CONSTANT[0]:1040 TEXTURE:0 SURFACE:0 SAMPLER:0
"""

_LOG = """ptxas info    : Compiling entry function '_Z8k_simt' for 'sm_90a'
ptxas info    : Function properties for _Z8k_simt
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 151 registers, used 1 barriers, 25600 bytes smem
"""


def _demangle(names):
    return [_MANGLED.get(n, n) for n in names]


def test_libs_parse_a_resource_listing():
    rows = kr.library_rows("packed_gemm", _USAGE, _LOG, _demangle)
    assert [(r["kernel"], r["registers"], r["shared"], r["local"],
             r["spill_stores"]) for r in rows] == [
        ("gemm_simt_kernel", 151, 26624, 0, 8),
        ("gemm_wgmma_kernel", 170, 1024, 16, None)]
    src = cm.load(str(CSRC / "packed_gemm.cu"),
                  "src/repro_torch/kernels/csrc/packed_gemm.cu")
    problems = kr.check_libraries(rows, [src], default_config())
    assert rows[0]["model_shared"] == 25600 + 1024
    assert len(problems) == 2, problems
    assert "spills 8/8 B" in problems[0]
    assert "170 registers over the ceiling 168" in problems[1]
    assert "16 B of local memory" in problems[1]
    clean = kr.library_rows("packed_gemm", _USAGE.replace("REG:170", "REG:168")
                            .replace("LOCAL:16", "LOCAL:0"), None, _demangle)
    assert kr.check_libraries(clean, [src], default_config()) == []
    assert clean[0]["spill_stores"] is None      # a cached build: no log


def test_libs_flag_a_kernel_with_no_instantiation_and_a_shared_mismatch():
    src = cm.load(str(CSRC / "packed_gemm.cu"),
                  "src/repro_torch/kernels/csrc/packed_gemm.cu")
    rows = kr.library_rows("packed_gemm", _USAGE.replace(
        "SHARED:26624", "SHARED:9999").split(" Function _Z7k_wg0")[0], None,
        _demangle)
    problems = kr.check_libraries(rows, [src], default_config())
    assert any("the model says 26624 B" in p for p in problems)
    assert any("gemm_wgmma_kernel has no instantiation" in p
               for p in problems)


def test_demangled_names_read_one_way():
    for name in ("void <unnamed>::simt::gemm_simt_kernel<<unnamed>::simt::"
                 "Tile<(int)128, (int)64, (int)8, (int)4>>(<unnamed>::simt::"
                 "Params)",
                 "void (anonymous namespace)::simt::gemm_simt_kernel<(anonymous"
                 " namespace)::simt::Tile<128, 64, 8, 4> >((anonymous "
                 "namespace)::simt::Params)"):
        inst = kr._signature_free(kr.normalize(name))
        assert kr.base_name(inst) == "gemm_simt_kernel"
        assert [a.replace(" ", "") for a in kr.template_args(inst)] == [
            "simt::Tile<128,64,8,4>"]


def test_ptxas_log_resources():
    assert kr.kernel_resources(_LOG, _demangle) == [
        (_MANGLED["_Z8k_simt"], 151, 8, 8)]
