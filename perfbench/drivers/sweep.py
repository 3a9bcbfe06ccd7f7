"""Training sweep: ``launch/sweep.py::run_sweep`` over the mix's task list.

Set-up builds the model and starts one ``run_sweep`` (AdamW, the mix's
optimizer settings, ``auto_nppn`` under ``hbm_fraction`` of the card):
it probes, packs the pool, attaches the first tasks and runs its first
``open_after_steps`` pool steps. The window opens when pool step
``open_after_steps`` completes and closes at the completion of the first
step at least ``seconds`` later (and after the compared tasks' compared
steps, which at the cell's length come within its first seconds), which
stops the sweep. A step completes
when its first lane's loss has been read on the host (the sweep reads
every lane's loss, which waits for the step's work on the card). Lanes
that finish are refilled from the task queue inside the window, as in any
sweep.

The weights of every task are the benchmark's: the port's ``Model`` is
handed a subclass whose ``init`` draws the task's parameters from the
generator's seed with ``weights.make``; the reference draws the same.

Correctness: the compared tasks are the first ``compare_tasks`` that a
refill attached inside the window (their first step completes after the
window opened), so the comparison judges lanes that the pool reused. The
harness reads each one's first ``compare_steps`` losses, its first
moment after one step and its parameters after the compared steps, from
the live pool, while the window runs. After the window the family's
reference runs the same AdamW steps in f32 on the same parameters and
batches. Read, by the worst task: the first step's loss and every step's
(relative gaps); by the worst leaf, the norm of the first step's gradient
as the optimizer took it (read from the first moment after one step) and
the norm of the parameters' change after the compared steps, each gap
against the larger of the reference's norm of that leaf and of the
median leaf. Leaves whose reference gradient is under a thousandth of the
median leaf's are left out of the change. The cell compares the numbers
its limits file names.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from perfbench import counts, reference, traffic, weights
from perfbench.common import check, port_config
from perfbench.trace import Tracer


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class WindowClosed(Exception):
    pass


def _pool_in_flight():
    """The lane pool of the ``RefillExecutor.run`` on the caller's stack.

    Temporary: ``run_sweep`` hands its callbacks no lane state, so the
    harness looks for it on the stack until the program offers a hook
    with a finished step's lane state."""
    from repro_torch.core.lanepool import RefillExecutor
    code = RefillExecutor.run.__code__
    f = sys._getframe(1)
    while f is not None and f.f_code is not code:
        f = f.f_back
    if f is None:
        raise RuntimeError("no RefillExecutor.run on the stack")
    return f.f_locals["self"].pool


def _leaf_norms(tree) -> list:
    from perfbench.reference.dense import get, leaf_names
    return torch.stack([get(tree, n).float().norm()
                        for n in leaf_names(tree)]).tolist()


class _Window:
    def __init__(self, open_after: int, seconds: float, trace_s: float,
                 tracer, compared):
        self.open_after, self.seconds, self.trace_s = (open_after, seconds,
                                                       trace_s)
        self.tracer = tracer
        self.compared = compared        # () -> the compared steps all ran
        self.issued = self.done = 0
        self.steps = []                  # (completion time, active, capacity)
        self.pending = None
        self.t_open = self.t_close = None
        self.traced = False

    def issued_step(self, active: int, capacity: int):
        self.issued += 1
        self.pending = (active, capacity)

    def lane_read(self):
        """Called at each lane's loss read; the first after a step was
        issued completes it."""
        if self.done == self.issued:
            return
        now = time.perf_counter()
        self.done += 1
        self.steps.append((now, *self.pending))
        if self.t_open is None:
            if self.done == self.open_after:
                self.t_open = now
                if self.tracer:
                    self.tracer.start()
            return
        if (self.tracer and not self.traced
                and now >= self.t_open + self.trace_s):
            self.traced = True
            self.tracer.stop()
        if now >= self.t_open + self.seconds and self.compared():
            self.t_close = now
            if self.tracer and not self.traced:
                self.traced = True
                self.tracer.stop()
            raise WindowClosed()

    def in_window(self) -> list:
        return [s for s in self.steps if self.t_open < s[0] <= self.t_close]


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        plant=None) -> dict:
    """One run of a sweep cell; ``plant(model_class)``, where given,
    returns a subclass of the benchmark's model class that breaks the
    port's step (the tests' and the calibration's faults)."""
    from repro_torch import optim
    from repro_torch.core.monitor import TenantGauges
    from repro_torch.launch.sweep import SweepTask, run_sweep
    from repro_torch.models.model import Model

    port, tr = cell["config"]["port"], cell["traffic"]
    fam = reference.family(port["family"])
    layout = fam.layout(port)
    dev = torch.device(device)

    class BenchModel(Model):
        def init(self, generator):
            return weights.make(layout, generator.initial_seed(), self.device)

    if plant is not None:
        BenchModel = plant(BenchModel)
    model = BenchModel(port_config(cell["config"]), device=dev)
    spec = traffic.sweep_tasks(tr, seed)
    tasks = [SweepTask(id=i, lr=lr, seed=s, steps=b)
             for i, (s, lr, b) in enumerate(spec)]
    vocab = port["vocab_size"]

    def batch_fn(task_seed, step):
        return traffic.lm_batch(tr, vocab, task_seed, step)

    n_cmp, n_steps = tr["compare_tasks"], tr["compare_steps"]
    b1 = tr["optimizer"]["b1"]
    prog: dict = {}                      # task id -> what the pool held
    win = _Window(tr["open_after_steps"], seconds,
                  tr.get("trace_seconds", seconds),
                  Tracer() if trace else None,
                  lambda: len(prog) == n_cmp and all(
                      len(r["losses"]) >= n_steps for r in prog.values()))

    def early_stop(task, step_idx, loss):
        win.lane_read()
        if win.done == 1:
            first_pack.append(task.id)
        if (step_idx == 0 and win.done > win.open_after
                and len(prog) < n_cmp and task.steps >= n_steps):
            prog[task.id] = {"losses": [], "grad_norms": None,
                             "delta_norms": None}
        if task.id in prog and step_idx < n_steps:
            rec = prog[task.id]
            rec["losses"].append(float(loss))
            if step_idx in (0, n_steps - 1):
                pool = _pool_in_flight()
                lane = pool.owner.index(task.id)
                if step_idx == 0:
                    mu = _lane(pool.opt_state["mu"], lane)
                    rec["grad_norms"] = [n / (1 - b1) for n in _leaf_norms(mu)]
                if step_idx == n_steps - 1:
                    p0 = weights.make(layout, task.seed, dev)
                    p = _lane(pool.params, lane)
                    rec["delta_norms"] = _leaf_norms(_diff(p, p0))
                    del p0
        return False

    pools = []
    first_pack: list = []               # tasks of the pool's first step

    class Gauges(TenantGauges):
        def on_lane_sample(self, user, gang, active, capacity):
            super().on_lane_sample(user, gang, active, capacity)
            win.issued_step(active, capacity)

        def on_dispatch(self, user, nodes, lanes, **kw):
            super().on_dispatch(user, nodes=nodes, lanes=lanes, **kw)
            pools.append((win.issued, lanes))

    budget = None
    if tr.get("hbm_fraction") and dev.type == "cuda":
        budget = tr["hbm_fraction"] * torch.cuda.get_device_properties(
            dev).total_memory
    try:
        run_sweep(model, tasks, batch_fn=batch_fn, steps=1,
                  hbm_budget=budget, max_pack=tr.get("max_pack"),
                  opt=optim.adamw(**tr["optimizer"]), gauges=Gauges(),
                  early_stop=early_stop)
        raise RuntimeError("the task list ran dry before the window "
                           "closed: give the mix more tasks")
    except WindowClosed:
        pass
    gc.collect()
    mem = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        mem = int(torch.cuda.max_memory_allocated())
    summary = win.tracer.summary() if win.tracer else None

    steps = win.in_window()
    window = win.t_close - win.t_open
    lane_steps = sum(a for _, a, _ in steps)
    tokens = lane_steps * tr["rows"] * tr["seq"]
    times = [win.t_open] + [t for t, _, _ in steps]
    step_ms = [1e3 * (b - a) for a, b in zip(times, times[1:])]
    flops = lane_steps * counts.train_step_flops(port, tr["rows"], tr["seq"])

    setup_ms = [round(1e3 * (b[0] - a[0]), 1)
                for a, b in zip(win.steps, win.steps[1:win.open_after])]
    log(f"[sweep] pools (step, lanes) {pools}; {len(steps)} steps and "
        f"{lane_steps} lane steps in {window:.3f} s, step ms median "
        f"{statistics.median(step_ms):.2f} min {min(step_ms):.2f} max "
        f"{max(step_ms):.2f}; set-up steps {setup_ms} ms; active lanes "
        f"{''.join(str(a) for _, a, _ in steps)}; peak {mem / 1e9:.2f} GB")
    t_ref = time.perf_counter()
    checks = compare(fam, port, layout, spec, batch_fn, prog, tr,
                     cell["limits"], dev)
    log(f"[sweep] reference {time.perf_counter() - t_ref:.2f} s")
    return {
        "t_open": win.t_open, "window_s": window,
        "attempted": lane_steps, "failed": 0,
        "e2e": {"train_tokens_per_s": tokens / window},
        "ctx": {"train": {"window_s": window, "flops": flops,
                          "step_ms_median": statistics.median(step_ms),
                          "lane_steps": lane_steps,
                          "first_pack": first_pack,
                          "lane_slots": sum(c for _, _, c in steps)},
                "trace": summary},
        "checks": checks, "memory_peak_bytes": mem,
        "compared": {"fam": fam, "port": port, "layout": layout,
                     "spec": spec, "batch_fn": batch_fn, "prog": prog,
                     "traffic": tr},
    }


def _lane(tree, lane: int):
    from repro_torch.core.packing import tree_get_lane
    return tree_get_lane(tree, lane)


def _diff(a, b):
    if isinstance(a, dict):
        return {k: _diff(a[k], b[k]) for k in a}
    return a.float() - b.float()


def gaps(prog: dict, ref: dict, rule_floor: float = 1e-3) -> dict:
    """The numbers of one task, program against reference (see the
    module docstring); a cell compares those its limits file names."""
    return {k: v[0] for k, v in gap_detail(prog, ref, rule_floor).items()}


def gap_detail(prog: dict, ref: dict, rule_floor: float = 1e-3) -> dict:
    """Each number as (value, where): the first step's loss gap; each
    step's loss gap; the worst leaf's gradient and change gaps with the
    leaf's name."""
    steps = [abs(p - r) / abs(r)
             for p, r in zip(prog["losses"], ref["losses"])]

    def worst(p_norms, r_norms, keep):
        med = statistics.median(r_norms)
        rows = [(abs(p - r) / max(r, med), name) for p, r, k, name in
                zip(p_norms, r_norms, keep, ref["names"]) if k]
        return max(rows)

    g_ref = ref["grad_norms"]
    med_g = statistics.median(g_ref)
    everyone = [True] * len(g_ref)
    moved = [g >= rule_floor * med_g for g in g_ref]
    return {"loss1_gap": (steps[0], "step 1"),
            "loss_gap": (max(steps), steps),
            "grad_gap": worst(prog["grad_norms"], g_ref, everyone),
            "update_gap": worst(prog["delta_norms"], ref["delta_norms"],
                                moved)}


def compare(fam, port, layout, spec, batch_fn, prog, tr, limits, dev,
            precision: str = "f32") -> list:
    """The reference over each compared task's first steps, and the
    worst gap over the tasks of each number the limits name, beside its
    limit."""
    worst = dict.fromkeys(limits, 0.0)
    if len(prog) < tr["compare_tasks"]:
        raise RuntimeError(f"{len(prog)} of {tr['compare_tasks']} compared "
                           "tasks attached in the window: lengthen it")
    for tid, rec in prog.items():
        task_seed, lr, _ = spec[tid]
        if len(rec["losses"]) < tr["compare_steps"]:
            raise RuntimeError(f"task {tid} ran fewer than the compared "
                               "steps in the window: lengthen it")
        ref = reference_run(fam, port, layout, task_seed, lr, batch_fn, tr,
                            dev, precision)
        got = gaps(rec, ref)
        for k in worst:
            worst[k] = max(worst[k], got[k])
    return [check(k, v, limits[k]) for k, v in worst.items()]


def reference_run(fam, port, layout, task_seed, lr, batch_fn, tr, dev,
                  precision: str = "f32") -> dict:
    p0 = weights.make(layout, task_seed, dev)
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in batch_fn(task_seed, s).items()}
               for s in range(tr["compare_steps"])]
    out = fam.train(p0, batches, lr, port, tr["optimizer"], precision)
    del p0
    return out
