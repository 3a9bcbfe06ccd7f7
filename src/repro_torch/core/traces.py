"""Seeded deterministic workload traces for the replay testbed (a copy of
``repro.core.traces``; its float sums go through
``simulate.left_fold_sum``).

The simulator's correctness tests run hand-built mixes of tens of jobs;
the paper's claim (utilization / wait-time gains from triples-mode
sharing) is about *center scale* — LLSC replays thousands of jobs with
diurnal load, bursty tenants and heavy-tailed sizes. This module is the
substrate that closes that gap:

  * ``TraceSpec`` / ``TenantSpec`` — a declarative, frozen description of
    a workload: tenant weights, per-tenant burst windows, a diurnal
    arrival curve, bounded-Pareto job sizes and a per-kind shape model
    (sweep / train / serve, mirroring ``simulate.mixed_workload``).
  * ``generate(spec)`` — spec -> ``List[SimJob]``, bit-deterministic for
    a fixed seed: one Philox stream, fixed draw order, no wall clocks.
    Every generated job is admissible under the default
    ``MemoryAdmission`` profile BY CONSTRUCTION (bytes_per_lane is drawn
    under the pack-factor cap), so a trace never trips the 21/48-style
    OOM path unless a test wants it to.
  * ``save_jsonl`` / ``load_jsonl`` — the committed canonical suite under
    ``benchmarks/traces/``. Floats round-trip exactly (json repr), so a
    loaded trace replays bit-identically to the generated one.
  * ``CANONICAL`` + ``ReplayConfig`` — the named suite the scheduler-
    quality CI gate replays through ``compare_modes``; regenerate with
    ``python -m repro_torch.core.traces --out benchmarks/traces``.
  * ``perf_spec(n_events)`` + ``scaled_to_utilization`` — sizing helpers
    for the million-event throughput benchmark
    (benchmarks/bench_trace_replay.py).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import simulate as S
from . import tenancy as ten
from . import triples as T

__all__ = [
    "TenantSpec", "TraceSpec", "ReplayConfig", "generate",
    "save_jsonl", "load_jsonl", "trace_path",
    "CANONICAL", "REPLAY", "KIND_INTENSITY", "replay_kwargs",
    "perf_spec", "scaled_to_utilization", "offered_node_seconds",
]


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's arrival behaviour within a trace.

    ``weight`` is the tenant's share of total arrivals. Bursts model the
    LLSC pattern of a user submitting a parameter sweep all at once:
    ``n_bursts`` windows of ``burst_len_s`` seconds, inside which the
    tenant's arrival intensity is multiplied by ``burst_gain``.
    """
    name: str
    weight: float = 1.0
    # (kind, probability) rows; must sum to 1
    kinds: Tuple[Tuple[str, float], ...] = (
        ("sweep", 0.6), ("train", 0.25), ("serve", 0.15))
    n_bursts: int = 0
    burst_len_s: float = 120.0
    burst_gain: float = 6.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be positive: {self}")
        total = S.left_fold_sum(p for _, p in self.kinds)
        if abs(total - 1.0) > 1e-9:
            raise ValueError(f"kind probabilities sum to {total}, not 1")


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Declarative description of a whole workload trace.

    Arrivals follow an inhomogeneous Poisson process sampled by thinning:
    the base intensity is modulated by a diurnal sinusoid
    ``1 + diurnal_amp * sin(2*pi*t / diurnal_period_s)`` (clamped at 0)
    and, per tenant, by that tenant's burst windows. Job sizes come from
    a bounded Pareto (``tail_alpha`` shape over
    [``tasks_min``, ``tasks_max``]) so a small ``tail_alpha`` produces
    the heavy tail real cluster logs show; per-task seconds are
    lognormal, truncated at ``task_s_max``.
    """
    name: str
    seed: int
    n_jobs: int
    horizon_s: float
    tenants: Tuple[TenantSpec, ...]
    diurnal_amp: float = 0.0
    diurnal_period_s: float = 7200.0
    tail_alpha: float = 1.5
    tasks_min: int = 2
    tasks_max: int = 256
    task_s_mu: float = 0.7              # ln-seconds
    task_s_sigma: float = 0.6
    task_s_max: float = 600.0

    def __post_init__(self):
        if self.n_jobs < 1 or self.horizon_s <= 0:
            raise ValueError(f"empty trace: {self}")
        if not self.tenants:
            raise ValueError("need at least one tenant")
        if not 0 <= self.diurnal_amp <= 1:
            raise ValueError(f"diurnal_amp must be in [0,1]: {self}")
        if self.tail_alpha <= 0 or self.tasks_min < 1 \
                or self.tasks_max < self.tasks_min:
            raise ValueError(f"bad size distribution: {self}")


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """How the quality gate replays a canonical trace: cluster size plus
    which policy layers ``compare_modes`` should enable on top of the
    exclusive/shared pair."""
    n_nodes: int
    lane_refill: bool = True
    preempt: bool = True
    repack: bool = True
    spatial: bool = True
    pack_slowdown: float = 0.15
    target_util: float = 0.0            # >0: write_canonical_suite rescales
                                        # submit times so offered load is
                                        # target_util x capacity — without
                                        # this the suite has zero queueing
                                        # and the wait metrics gate nothing
    roofline: bool = False              # feed the mode planner the
                                        # roofline-measured per-kind
                                        # intensity (KIND_INTENSITY) via
                                        # spatial.measured_interference
                                        # instead of declared-only scores


# Roofline-measured memory-bound fraction per job kind — the simulator's
# stand-in for the live record-at-first-dispatch path (the scheduler
# records IntensityProfile.memory_bound_frac under key "kind:<kind>").
# Values are what IntensityProfile.from_compiled reports for the three
# program families on the default HW preset: decode-style serve steps are
# HBM-bandwidth-bound, packed training steps are MXU-bound, small sweep
# steps sit in between.
KIND_INTENSITY: Dict[str, float] = {
    "serve": 0.85,
    "train": 0.05,
    "sweep": 0.35,
}


def replay_kwargs(cfg: ReplayConfig) -> dict:
    """The ``compare_modes`` keyword set for ``cfg`` — one place so the
    bench, the CI gate and the tests replay with IDENTICAL policies."""
    kw: dict = {"lane_refill": cfg.lane_refill,
                "pack_slowdown": cfg.pack_slowdown}
    if cfg.preempt:
        kw["preemption"] = ten.PreemptionPolicy(wait_threshold=30.0,
                                                resume_overhead=5.0)
    if cfg.repack:
        from .repack import RepackPolicy
        kw["repack"] = RepackPolicy()
    if cfg.spatial:
        from . import spatial as sp
        if cfg.roofline:
            adm = ten.MemoryAdmission()
            for kind, frac in KIND_INTENSITY.items():
                adm.record_intensity(f"kind:{kind}", frac)
            kw["spatial"] = sp.ModePlanner(
                admission=adm, interference=sp.measured_interference(adm))
        else:
            kw["spatial"] = sp.ModePlanner()
    return kw


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _bounded_pareto(rng: np.random.Generator, alpha: float,
                    lo: int, hi: int) -> int:
    """Bounded Pareto over [lo, hi] by inverse CDF — the standard
    heavy-tail job-size model (alpha < 2 gives infinite variance on the
    unbounded version, which is what center logs look like)."""
    if lo == hi:
        return lo
    u = rng.random()
    la, ha = lo ** -alpha, hi ** -alpha
    x = (la - u * (la - ha)) ** (-1.0 / alpha)
    return int(min(hi, max(lo, math.floor(x))))


# per-kind shape model: triples candidates and load/interference ranges.
# sweeps are packed small tasks (the paper's Fig 2 "lone small task at
# ~25% chip load" case), train jobs hold whole chips at high load, serve
# jobs are latency replicas — memory-bound, so they carry the
# interference intensity the spatial planner exists to quarantine.
_KIND_SHAPES: Dict[str, dict] = {
    "sweep": {"trips": (T.Triples(1, 4, 1), T.Triples(1, 8, 1),
                        T.Triples(2, 8, 1)),
              "load": (0.2, 0.45), "interference": (0.0, 0.0),
              "tasks_scale": 1.0},
    "train": {"trips": (T.Triples(1, 1, 4), T.Triples(2, 1, 4),
                        T.Triples(4, 1, 4)),
              "load": (0.75, 1.0), "interference": (0.0, 0.1),
              "tasks_scale": 0.25},
    "serve": {"trips": (T.Triples(1, 2, 1), T.Triples(1, 4, 1)),
              "load": (0.3, 0.6), "interference": (0.2, 0.5),
              "tasks_scale": 0.5},
}


def _intensity(spec: TraceSpec, tenant: TenantSpec,
               bursts: Sequence[Tuple[float, float]], t: float) -> float:
    """Relative arrival intensity for ``tenant`` at virtual time ``t``."""
    lam = 1.0
    if spec.diurnal_amp:
        lam += spec.diurnal_amp * math.sin(
            2.0 * math.pi * t / spec.diurnal_period_s)
        lam = max(0.0, lam)
    for b0, b1 in bursts:
        if b0 <= t < b1:
            lam *= tenant.burst_gain
            break
    return lam


def generate(spec: TraceSpec,
             node_spec: Optional[T.NodeSpec] = None,
             headroom: float = 0.9) -> List[S.SimJob]:
    """Materialise ``spec`` into a sorted, admissible job list.

    Determinism contract: one Philox stream keyed by ``spec.seed``, a
    fixed draw order (tenant bursts, then per-job fields), and no
    wall-clock or platform input — the same spec yields a bit-identical
    trace on every machine, which is what lets CI compare replay metrics
    EXACTLY instead of with tolerances.
    """
    node_spec = node_spec or T.NodeSpec()
    rng = np.random.Generator(np.random.Philox(key=spec.seed))

    # 1. burst windows per tenant (drawn first so adding jobs to a spec
    #    never shifts the windows)
    windows: Dict[str, List[Tuple[float, float]]] = {}
    for tn in spec.tenants:
        ws = []
        for _ in range(tn.n_bursts):
            b0 = float(rng.random()) * spec.horizon_s
            ws.append((b0, b0 + tn.burst_len_s))
        windows[tn.name] = ws

    # 2. arrivals: pick the tenant by weight, then thin a uniform draw
    #    against that tenant's intensity curve (peak-normalised)
    names = [tn.name for tn in spec.tenants]
    by_name = {tn.name: tn for tn in spec.tenants}
    wsum = S.left_fold_sum(tn.weight for tn in spec.tenants)
    probs = np.array([tn.weight / wsum for tn in spec.tenants])
    peak: Dict[str, float] = {
        tn.name: (1.0 + spec.diurnal_amp)
        * (tn.burst_gain if tn.n_bursts else 1.0)
        for tn in spec.tenants}

    rows: List[Tuple[float, str, str]] = []       # (t, user, kind)
    while len(rows) < spec.n_jobs:
        user = names[int(rng.choice(len(names), p=probs))]
        tn = by_name[user]
        t = float(rng.random()) * spec.horizon_s
        if rng.random() * peak[user] > _intensity(spec, tn,
                                                  windows[user], t):
            continue                               # thinned out
        kp = rng.random()
        kind = tn.kinds[-1][0]
        acc = 0.0
        for k, p in tn.kinds:
            acc += p
            if kp < acc:
                kind = k
                break
        rows.append((t, user, kind))
    rows.sort(key=lambda r: (r[0], r[1]))

    # 3. per-job shapes, in arrival order
    jobs: List[S.SimJob] = []
    for jid, (t, user, kind) in enumerate(rows):
        sh = _KIND_SHAPES[kind]
        trip = sh["trips"][int(rng.integers(len(sh["trips"])))]
        n_tasks = _bounded_pareto(
            rng, spec.tail_alpha, spec.tasks_min,
            max(spec.tasks_min,
                int(round(spec.tasks_max * sh["tasks_scale"]))))
        task_s = float(min(
            spec.task_s_max,
            math.exp(spec.task_s_mu
                     + spec.task_s_sigma * rng.standard_normal())))
        lo, hi = sh["load"]
        load = float(lo + (hi - lo) * rng.random())
        lo, hi = sh["interference"]
        interference = float(lo + (hi - lo) * rng.random()) if hi else 0.0
        # admissible by construction: the per-lane footprint is drawn
        # strictly under the pack-factor budget at the given headroom
        pack = trip.pack_factor(node_spec)
        budget = headroom * node_spec.hbm_per_chip / pack
        bpl = float((0.05 + 0.90 * rng.random()) * budget)
        jobs.append(S.SimJob(
            id=jid, user=user, submit_t=round(t, 6), kind=kind,
            n_tasks=n_tasks, task_s=round(task_s, 6), trip=trip,
            bytes_per_lane=round(bpl, 3), load_frac=round(load, 6),
            interference=round(interference, 6)))
    return jobs


# ---------------------------------------------------------------------------
# sizing helpers (perf bench)
# ---------------------------------------------------------------------------

def offered_node_seconds(jobs: Sequence[S.SimJob],
                         node_spec: Optional[T.NodeSpec] = None,
                         pack_slowdown: float = 0.15) -> float:
    """Total node-seconds the trace offers at full granted width — the
    deterministic load estimate ``scaled_to_utilization`` divides by."""
    node_spec = node_spec or T.NodeSpec()
    return S.left_fold_sum(
        S.job_duration(j, j.trip, node_spec, pack_slowdown) * j.trip.nnode
        for j in jobs)


def scaled_to_utilization(jobs: List[S.SimJob], n_nodes: int,
                          target: float,
                          node_spec: Optional[T.NodeSpec] = None,
                          pack_slowdown: float = 0.15) -> List[S.SimJob]:
    """Linearly rescale submit times so the offered load over the trace's
    span is ``target`` x the cluster's node-second capacity. Order and
    ties are preserved (a pure monotone reparameterisation), so the
    metamorphic determinism guarantees carry over; a target below 1
    keeps the queue depth bounded, which is what makes the million-event
    replay's cost per event flat."""
    if not jobs or target <= 0:
        return list(jobs)
    node_spec = node_spec or T.NodeSpec()
    span = max(j.submit_t for j in jobs)
    if span <= 0:
        return list(jobs)
    need = offered_node_seconds(jobs, node_spec, pack_slowdown) \
        / (target * n_nodes)
    f = need / span
    return [dataclasses.replace(j, submit_t=j.submit_t * f) for j in jobs]


def perf_spec(n_events: int, seed: int = 1009) -> TraceSpec:
    """Spec for the throughput benchmark: ``n_events // 2`` jobs (one
    submit + one finish event each — no preempt/refill layers in the
    perf replay), a flat arrival curve and a mild tail so the queue
    depth stays bounded once ``scaled_to_utilization`` pins the offered
    load at ~0.9."""
    n_jobs = max(1, n_events // 2)
    return TraceSpec(
        name=f"perf_{n_events}", seed=seed, n_jobs=n_jobs,
        horizon_s=float(n_jobs),        # rescaled afterwards anyway
        tenants=tuple(TenantSpec(name=f"u{i}", kinds=(("sweep", 1.0),))
                      for i in range(16)),
        tail_alpha=3.0, tasks_min=8, tasks_max=32,
        task_s_mu=0.7, task_s_sigma=0.25)


# ---------------------------------------------------------------------------
# JSONL persistence
# ---------------------------------------------------------------------------

_ROW_FIELDS = ("id", "user", "submit_t", "kind", "n_tasks", "task_s",
               "nnode", "nppn", "ntpp", "bytes_per_lane", "load_frac",
               "interference")


def save_jsonl(path: str, jobs: Sequence[S.SimJob], *,
               name: str, seed: int,
               replay: Optional[ReplayConfig] = None) -> None:
    """Write header + one compact row per job. ``json`` emits the
    ``repr`` of each float, which round-trips IEEE-754 doubles exactly —
    load_jsonl(save_jsonl(x)) replays bit-identically to ``x``."""
    header: dict = {"schema": 1, "name": name, "seed": seed,
                    "n_jobs": len(jobs), "fields": list(_ROW_FIELDS)}
    if replay is not None:
        header["replay"] = dataclasses.asdict(replay)
    with open(path, "w") as f:
        f.write(json.dumps(header, sort_keys=True) + "\n")
        for j in jobs:
            row = [j.id, j.user, j.submit_t, j.kind, j.n_tasks, j.task_s,
                   j.trip.nnode, j.trip.nppn, j.trip.ntpp,
                   j.bytes_per_lane, j.load_frac, j.interference]
            f.write(json.dumps(row) + "\n")


def load_jsonl(path: str) -> Tuple[dict, List[S.SimJob]]:
    """Read a trace file back: (header, jobs). Triples instances are
    interned so a 10^6-event trace doesn't hold 500k duplicate shape
    objects."""
    trips: Dict[Tuple[int, int, int], T.Triples] = {}
    jobs: List[S.SimJob] = []
    with open(path) as f:
        header = json.loads(f.readline())
        if header.get("schema") != 1:
            raise ValueError(f"unknown trace schema in {path}: {header}")
        for line in f:
            (jid, user, submit_t, kind, n_tasks, task_s,
             nnode, nppn, ntpp, bpl, load, intf) = json.loads(line)
            key = (nnode, nppn, ntpp)
            trip = trips.get(key)
            if trip is None:
                trip = trips[key] = T.Triples(*key)
            jobs.append(S.SimJob(
                id=jid, user=user, submit_t=submit_t, kind=kind,
                n_tasks=n_tasks, task_s=task_s, trip=trip,
                bytes_per_lane=bpl, load_frac=load, interference=intf))
    if len(jobs) != header["n_jobs"]:
        raise ValueError(f"{path}: header says {header['n_jobs']} jobs, "
                         f"file has {len(jobs)}")
    return header, jobs


def replay_config_from(header: dict) -> ReplayConfig:
    return ReplayConfig(**header["replay"])


# ---------------------------------------------------------------------------
# the canonical suite (committed under benchmarks/traces/)
# ---------------------------------------------------------------------------

_MIX = (("sweep", 0.6), ("train", 0.25), ("serve", 0.15))

CANONICAL: Dict[str, TraceSpec] = {
    # tiny: small enough for the live-vs-sim agreement test to replay
    # through run_queued in one test
    "tiny": TraceSpec(
        name="tiny", seed=7, n_jobs=16, horizon_s=90.0,
        tenants=(TenantSpec("alice", kinds=_MIX),
                 TenantSpec("bob", kinds=_MIX)),
        tasks_max=32, task_s_sigma=0.3),
    # flat multi-tenant mix — the baseline quality point
    "steady_mix": TraceSpec(
        name="steady_mix", seed=11, n_jobs=400, horizon_s=3600.0,
        tenants=tuple(TenantSpec(f"u{i}", kinds=_MIX) for i in range(6))),
    # strong diurnal curve: two day/night cycles over the horizon
    "diurnal": TraceSpec(
        name="diurnal", seed=13, n_jobs=500, horizon_s=14400.0,
        diurnal_amp=0.8, diurnal_period_s=7200.0,
        tenants=tuple(TenantSpec(f"u{i}", kinds=_MIX) for i in range(4))),
    # one tenant dumps sweeps in bursts against three steady tenants
    "bursty_tenant": TraceSpec(
        name="bursty_tenant", seed=17, n_jobs=450, horizon_s=5400.0,
        tenants=(TenantSpec("bursty", weight=1.5,
                            kinds=(("sweep", 0.9), ("serve", 0.1)),
                            n_bursts=4, burst_len_s=180.0,
                            burst_gain=8.0),
                 TenantSpec("u0", kinds=_MIX),
                 TenantSpec("u1", kinds=_MIX),
                 TenantSpec("u2", kinds=_MIX))),
    # alpha ~ 1.1: the LLSC-log-like heavy tail (a few huge sweeps
    # dominate offered load)
    "heavy_tail": TraceSpec(
        name="heavy_tail", seed=19, n_jobs=400, horizon_s=5400.0,
        tail_alpha=1.1, tasks_max=2048,
        tenants=tuple(TenantSpec(f"u{i}", kinds=_MIX) for i in range(5))),
    # memory-bound (serve-heavy decode tenant) against compute-bound
    # (train-heavy pretrain tenant): the mix where the roofline-measured
    # intensity signal (ReplayConfig.roofline + KIND_INTENSITY) changes
    # planner decisions — serve jobs get quarantined onto slices, train
    # jobs keep packing
    "roofline_mix": TraceSpec(
        name="roofline_mix", seed=23, n_jobs=360, horizon_s=5400.0,
        tenants=(TenantSpec("decode", weight=1.2,
                            kinds=(("serve", 0.8), ("sweep", 0.2))),
                 TenantSpec("pretrain",
                            kinds=(("train", 0.7), ("sweep", 0.3))),
                 TenantSpec("mixed", kinds=_MIX)),
        tasks_max=96),
}

REPLAY: Dict[str, ReplayConfig] = {
    "tiny": ReplayConfig(n_nodes=4, target_util=0.7),
    "steady_mix": ReplayConfig(n_nodes=24, target_util=0.85),
    "diurnal": ReplayConfig(n_nodes=24, target_util=0.9),
    "bursty_tenant": ReplayConfig(n_nodes=24, target_util=0.9),
    "heavy_tail": ReplayConfig(n_nodes=32, target_util=1.2),
    "roofline_mix": ReplayConfig(n_nodes=16, target_util=0.95,
                                 roofline=True),
}


def trace_path(root: str, name: str) -> str:
    return os.path.join(root, f"{name}.jsonl")


def write_canonical_suite(root: str) -> List[str]:
    """(Re)generate every canonical trace file under ``root``. The files
    are committed; CI replays them from the checkout, so regeneration is
    only needed when a spec here changes (docs/BENCHMARKS.md)."""
    os.makedirs(root, exist_ok=True)
    out = []
    for name, spec in CANONICAL.items():
        cfg = REPLAY[name]
        jobs = generate(spec)
        if cfg.target_util > 0:
            jobs = scaled_to_utilization(jobs, cfg.n_nodes,
                                         cfg.target_util,
                                         pack_slowdown=cfg.pack_slowdown)
        path = trace_path(root, name)
        save_jsonl(path, jobs, name=name, seed=spec.seed, replay=cfg)
        out.append(path)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="benchmarks/traces",
                    help="directory for the canonical trace files")
    args = ap.parse_args()
    for p in write_canonical_suite(args.out):
        print(p)
