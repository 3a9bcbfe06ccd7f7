"""Three-term roofline of one step (port of ``repro.roofline.analysis``).

    compute    = FLOPs        / peak_FLOP/s
    memory     = HBM bytes    / HBM_bw
    collective = collective bytes / link_bw

The reference reads the terms from a compiled XLA program (its HLO text,
counted per device). PyTorch runs eagerly and compiles no program, so the
port counts them by running the step once (``roofline.counting``): FLOPs
from ``torch.utils.flop_counter``, bytes from every aten op's operands and
results, and each kernel entry of ``kernels.ops`` as one leaf whose work
comes from its shapes. The collective term comes from the collectives the
run issues, recorded by ``counting.CollectiveCounter`` as ``CollectiveOp``s
and priced by the reference's rules (operand bytes over the link rate): a
step on a mesh (DTensor arguments) records DTensor's redistributions and
the explicit sums of a ``local_map`` region; a step on one card records
none, and its term is 0. The reference's ``parse_collectives`` of HLO text
is kept for HLO from elsewhere.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

# ---- hardware constants (per chip; the default is one NVIDIA H100) --------


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12        # bf16 FLOP/s
    hbm_bw: float = 3.35e12           # bytes/s
    ici_bw: float = 450e9             # bytes/s a device sends (link rate)
    hbm_bytes: float = 80e9

    @classmethod
    def for_arch(cls, arch: str) -> "HW":
        """Preset registry: the roofline terms mean something only against
        a named chip, so tables take an ``--arch`` instead of assuming
        one."""
        try:
            return cls(**_HW_PRESETS[arch])
        except KeyError:
            raise ValueError(
                f"unknown arch {arch!r}; known presets: "
                f"{sorted(_HW_PRESETS)}") from None


# Public per-chip numbers: bf16 peak, HBM bandwidth, link rate, HBM size.
# The TPU rows are the reference's (per-link ICI). h100 is NVIDIA's H100
# SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s of HBM3, 80 GB; its
# NVLink 4 is 900 GB/s counting both directions of 18 links, and the link
# term prices the bytes a device sends, so half of it, 450 GB/s.
_HW_PRESETS: Dict[str, dict] = {
    "v4": dict(peak_flops=275e12, hbm_bw=1228e9, ici_bw=50e9,
               hbm_bytes=32e9),
    "v5e": dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
                hbm_bytes=16e9),
    "v5p": dict(peak_flops=459e12, hbm_bw=2765e9, ici_bw=100e9,
                hbm_bytes=95e9),
    "v6e": dict(peak_flops=918e12, hbm_bw=1640e9, ici_bw=100e9,
                hbm_bytes=32e9),
    "h100": dict(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
                 hbm_bytes=80e9),
}


# ---- HLO collective parsing (the reference's, verbatim) -------------------

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")
_COLL_RE = re.compile(
    r"=\s*(\([^)]*\)|\w+\[[^\]]*\](?:\{[^}]*\})?)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\b")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LEGACY_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")


def _shape_bytes(typespec: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(typespec):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int

    @property
    def operand_bytes(self) -> int:
        if self.kind == "all-gather":
            return self.result_bytes // max(self.group_size, 1)
        if self.kind == "reduce-scatter":
            return self.result_bytes * self.group_size
        return self.result_bytes

    @property
    def traffic_bytes(self) -> int:
        """Ring-model per-device traffic."""
        n = max(self.group_size, 1)
        frac = (n - 1) / n if n > 1 else 0.0
        if self.kind == "all-reduce":
            return int(2 * self.result_bytes * frac)
        if self.kind == "all-gather":
            return int(self.result_bytes * frac)
        if self.kind == "reduce-scatter":
            return int(self.result_bytes * self.group_size * frac)
        return int(self.result_bytes * frac)


def parse_collectives(hlo_text: str) -> List[CollectiveOp]:
    ops: List[CollectiveOp] = []
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        typespec, kind, suffix = m.groups()
        if suffix == "-done":
            continue
        rb = _shape_bytes(typespec)
        gm = _GROUPS_RE.search(line)
        if gm:
            gsize = int(gm.group(2))
        else:
            gl = _GROUPS_LEGACY_RE.search(line)
            gsize = len(gl.group(1).split(",")) if gl else 1
        ops.append(CollectiveOp(kind, rb, gsize))
    return ops


def collective_totals(ops) -> tuple:
    """(operand bytes, ring traffic bytes, operand bytes by kind) of a list
    of ``CollectiveOp``s, as the reference sums its HLO's."""
    by_kind: Dict[str, int] = {}
    for op in ops:
        by_kind[op.kind] = by_kind.get(op.kind, 0) + op.operand_bytes
    return (sum(op.operand_bytes for op in ops),
            sum(op.traffic_bytes for op in ops), by_kind)


def model_flops(n_params: float, n_tokens: float, kind: str) -> float:
    """6·N·D for train (fwd+bwd), 2·N·D for inference forward."""
    return (6.0 if kind == "train" else 2.0) * n_params * n_tokens


@dataclasses.dataclass
class RooflineReport:
    """The reference's report over a counted step. ``flops_per_dev`` and
    ``bytes_per_dev`` are the counts of ``counting.count_step`` (the
    reference's HLO analysis has them from the compiled text, and its XLA
    ``cost_analysis`` cross-check has no counterpart). ``bytes_by_tag``
    holds each kernel leaf's bytes under its tag ("sdpa" for flash
    attention, "ssd" for the scan, as the reference tags those scopes)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float
    coll_operand_bytes: int           # 0 on one card (no collective)
    coll_traffic_bytes: int
    coll_by_kind: Dict[str, int]
    peak_mem_bytes: int
    arg_bytes: int
    model_flops_global: float
    hw: HW = dataclasses.field(default_factory=HW)
    bytes_by_tag: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_io_bytes: float = 0.0       # analytic kernel HBM traffic

    # ---- kernel-substituted memory term --------------------------------
    # The reference replaces the XLA fallback's traffic in the sdpa/ssd
    # scopes by the kernels' own in/out tensors. The port counts those
    # scopes as kernel leaves already, so with ``kernel_io_bytes`` set to
    # the leaves' bytes the substituted term equals the plain one.
    @property
    def bytes_per_dev_kernel(self) -> float:
        replaced = sum(self.bytes_by_tag.get(t, 0.0) for t in ("sdpa", "ssd"))
        return self.bytes_per_dev - replaced + self.kernel_io_bytes

    @property
    def t_memory_kernel(self) -> float:
        return self.bytes_per_dev_kernel / self.hw.hbm_bw

    @property
    def t_bound_kernel(self) -> float:
        return max(self.t_compute, self.t_memory_kernel, self.t_collective)

    @property
    def roofline_fraction_kernel(self) -> float:
        if self.t_bound_kernel == 0:
            return 0.0
        return (self.model_flops_global / self.chips / self.t_bound_kernel
                / self.hw.peak_flops)

    # ---- the three terms, in seconds ----
    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_operand_bytes / self.hw.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def flops_global(self) -> float:
        return self.flops_per_dev * self.chips

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: the remat and dispatch waste."""
        if self.flops_global == 0:
            return 0.0
        return self.model_flops_global / self.flops_global

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step runs at the
        bound: useful model FLOPs per chip-second over peak."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops_global / self.chips / self.t_bound
                / self.hw.peak_flops)

    def row(self) -> Dict[str, object]:
        """The reference's row; its ``hlo_gflops_dev`` is ``gflops_dev``
        here (counted, not read from HLO)."""
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "gflops_dev": self.flops_per_dev / 1e9,
            "hbm_gb_dev": self.bytes_per_dev / 1e9,
            "coll_gb_dev": self.coll_operand_bytes / 1e9,
            "peak_mem_gb_dev": self.peak_mem_bytes / 1e9,
            "model_gflops_global": self.model_flops_global / 1e9,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def attn_kernel_io_bytes(cfg, n_tokens_global: int, tp: int, dp: int,
                         kind: str) -> float:
    """Analytic per-device HBM traffic of the flash-attention and SSD
    kernels (q/k/v/out tensors only; intermediates stay on chip). Train ≈
    3× forward (backward recompute and grads). ``tp`` and ``dp`` are the
    tensor- and data-parallel sizes (1 and 1 on one card; the reference
    reads them from its mesh)."""
    from repro_torch.models.ssm import dims as ssm_dims
    t_l = max(1, n_tokens_global // max(1, dp))
    mult = 3.0 if kind == "train" else 1.0
    total = 0.0
    hd = cfg.resolved_head_dim
    if cfg.num_heads:
        n_attn = cfg.num_layers if cfg.family != "hybrid" else (
            cfg.num_layers // max(cfg.hybrid_attn_period, 1))
        if cfg.is_encdec:
            n_attn = cfg.num_encoder_layers + 2 * cfg.num_layers
        per_layer = t_l * hd * 2.0 * (2.0 * cfg.num_heads / tp
                                      + 2.0 * cfg.num_kv_heads)
        total += n_attn * per_layer
    if cfg.ssm is not None:
        d_in, nh, ch = ssm_dims(cfg.d_model, cfg.ssm)
        per_layer = t_l * 2.0 * (2.0 * d_in / tp + 2.0 * cfg.ssm.state_dim)
        total += cfg.num_layers * per_layer
    return total * mult


def analyze_step(fn, *args, arch: str, shape: str, n_params: float,
                 n_tokens: float, kind: str, hw: Optional[HW] = None,
                 mesh: str = "1", chips: int = 1) -> RooflineReport:
    """Run ``fn(*args)`` once under ``counting.count_step`` and build its
    per-device report: on one device, or on a mesh of ``chips`` (named
    ``mesh``) when the args are DTensors. ``peak_mem_bytes`` is the CUDA
    allocator's peak above what it held before the call when the args lie
    on a card, else 0; ``arg_bytes`` the args' (local) tensor bytes; the
    collective term prices the collectives the run issued."""
    from repro_torch.roofline import counting
    c = counting.count_step(fn, *args)
    operand, traffic, by_kind = collective_totals(c.collectives)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        flops_per_dev=float(c.flops), bytes_per_dev=float(c.bytes),
        coll_operand_bytes=operand, coll_traffic_bytes=traffic,
        coll_by_kind=by_kind,
        peak_mem_bytes=int(c.peak_bytes), arg_bytes=int(c.arg_bytes),
        model_flops_global=model_flops(n_params, n_tokens, kind),
        hw=hw or HW(), bytes_by_tag=dict(c.bytes_by_tag),
        kernel_io_bytes=sum(c.bytes_by_tag.get(t, 0.0)
                            for t in ("sdpa", "ssd")))


@dataclasses.dataclass(frozen=True)
class IntensityProfile:
    """A job's measured compute-vs-memory character, distilled from its
    step's roofline terms: the per-job signal the ``ModePlanner`` consumes
    (core/spatial.py ``measured_interference``).

    ``arithmetic_intensity`` is FLOPs per HBM byte (the roofline x-axis);
    ``memory_bound_frac`` is the share of the three roofline terms spent
    in HBM: near 1 for decode-style bandwidth-bound steps, lower for
    matmul-bound training. The latter is what the planner uses: two
    memory-bound jobs sharing a chip contend for the one resource that is
    already the bottleneck, while compute-bound jobs pack benignly.
    """
    arithmetic_intensity: float
    memory_bound_frac: float
    bottleneck: str

    @classmethod
    def from_report(cls, r: RooflineReport) -> "IntensityProfile":
        ai = (r.flops_per_dev / r.bytes_per_dev) if r.bytes_per_dev else 0.0
        total = r.t_compute + r.t_memory + r.t_collective
        mbf = (r.t_memory / total) if total else 0.0
        return cls(arithmetic_intensity=ai, memory_bound_frac=mbf,
                   bottleneck=r.bottleneck)

    @classmethod
    def from_step(cls, fn, *args, hw: Optional[HW] = None
                  ) -> "IntensityProfile":
        """From one run of ``fn(*args)`` (no model metadata needed): the
        form the scheduler records at first dispatch, the way
        ``MemoryAdmission.record_measured`` records HBM bytes. The
        reference's ``from_compiled`` reads a compiled XLA program."""
        from repro_torch.roofline import counting
        c = counting.count_step(fn, *args)
        hw = hw or HW()
        tc = c.flops / hw.peak_flops
        tm = c.bytes / hw.hbm_bw
        tl = collective_totals(c.collectives)[0] / hw.ici_bw
        total = tc + tm + tl
        terms = {"compute": tc, "memory": tm, "collective": tl}
        return cls(
            arithmetic_intensity=(c.flops / c.bytes) if c.bytes else 0.0,
            memory_bound_frac=(tm / total) if total else 0.0,
            bottleneck=max(terms, key=terms.get))

    @property
    def interference(self) -> float:
        """The planner-facing interference intensity in [0, 1]."""
        return min(1.0, max(0.0, self.memory_bound_frac))
