"""The port's ``run_sweep`` against the reference's on the CPU: the sweep
scenarios of tests/test_integration.py (parametric study, skewed budgets,
early stop, checkpoint resume, periodic checkpoints and raw callback
errors), tests/test_preemption.py (drain and resume at another capacity)
and tests/test_repack.py (adaptive packing), on ``stablelm-1.6b.reduced()``
and ``mamba2-130m.reduced()``, each through the "chunked" and the "kernel"
path (the kernels' plain versions here), and OOM backoff.

Both packages start from the same values: the port's lanes draw their
params from the reference's ``model.init`` at the task's seed (a test-only
``Model`` subclass). Per-task losses are held to the reference's run of
every (lr, seed) the scenarios use (one reference sweep per model: a
task's losses depend on its lr, seed and budget only, since lanes are
independent); the ``SweepResult`` counters, which depend on the schedule
alone, are held to the reference's ``run_sweep`` over the same scenario
with a one-weight model of the reference's interface (its step compiles
in a fraction of a second where the reduced LM's takes several). Where the
reference asserts bit-identity inside one package (drain/resume at
another capacity, adaptive against static packing), the port does too.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.faults import FaultPolicy as JFaultPolicy
from repro.core.repack import RepackPolicy as JRepackPolicy
from repro.launch.sweep import SweepTask as JSweepTask
from repro.launch.sweep import run_sweep as jrun_sweep
from repro.models import ParallelCtx as JCtx, build_model as jbuild
from repro_torch import configs
from repro_torch.core.faults import FaultPolicy, inject_failures
from repro_torch.core.lanepool import PoolStepError
from repro_torch.core.repack import RepackPolicy
from repro_torch.data import SyntheticLM
from repro_torch.launch.sweep import SweepTask, run_sweep
from repro_torch.models import ParallelCtx
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model

ARCHS = ["stablelm-1.6b", "mamba2-130m"]
IMPLS = ["chunked", "kernel"]
# the f32 parity bound: both packages step the same f32 model under AdamW
# (seen: <= 7e-6 on losses of 5-6 after 6 steps)
TOL = dict(rtol=2e-5, atol=2e-5)
SEQ, BATCH = 16, 2
COUNTERS = ("pack_factor", "global_steps", "lane_steps", "refills",
            "n_traces", "backoffs", "repacks", "capacity_trace", "preempted")
PARAM_LRS = (1e-3, 3e-3, 1e-2, 3e-2)
# every (lr, seed) a scenario runs, and the most steps it takes
ORACLE = ([(1e-3, s) for s in range(6)]
          + [(lr, s) for s, lr in enumerate(PARAM_LRS) if lr != 1e-3])
ORACLE_STEPS = 6

PORT = types.SimpleNamespace(run_sweep=run_sweep, SweepTask=SweepTask,
                             FaultPolicy=FaultPolicy,
                             RepackPolicy=RepackPolicy)
REF = types.SimpleNamespace(run_sweep=jrun_sweep, SweepTask=JSweepTask,
                            FaultPolicy=JFaultPolicy,
                            RepackPolicy=JRepackPolicy)


def _batch_fn(vocab):
    return lambda seed, step: SyntheticLM(
        vocab_size=vocab, seq_len=SEQ, batch_size=BATCH,
        seed=seed).batch(step)


# ---------------------------------------------------------------------------
# the scenarios, written once for both packages
# ---------------------------------------------------------------------------

def parametric(pkg, model, bf, tmp):
    tasks = [pkg.SweepTask(id=i, lr=lr, seed=i)
             for i, lr in enumerate(PARAM_LRS)]
    res = pkg.run_sweep(model, tasks, batch_fn=bf, steps=6, max_pack=4)
    assert all(len(v) == 6 for v in res.losses.values())
    assert res.pack_factor == 4
    assert len({round(v[-1], 6) for v in res.losses.values()}) > 1
    return [res]


def skewed(pkg, model, bf, tmp):
    budgets = [2, 6, 3, 5, 2, 4]
    tasks = [pkg.SweepTask(id=i, lr=1e-3, seed=i, steps=b)
             for i, b in enumerate(budgets)]
    res = pkg.run_sweep(model, tasks, batch_fn=bf, steps=99, max_pack=2)
    assert res.n_traces == 1
    assert {i: len(v) for i, v in res.losses.items()} == dict(
        enumerate(budgets))
    assert res.lane_steps == sum(budgets)
    assert res.global_steps < 6 + 5 + 4 and res.refills == len(tasks)
    return [res]


def early_stop(pkg, model, bf, tmp):
    tasks = [pkg.SweepTask(id=i, lr=1e-3, seed=i) for i in range(3)]
    res = pkg.run_sweep(model, tasks, batch_fn=bf, steps=5, max_pack=3,
                        early_stop=lambda t, s, loss: t.id == 1 and s >= 1)
    assert [len(res.losses[i]) for i in range(3)] == [5, 2, 5]
    return [res]


def checkpoint_resume(pkg, model, bf, tmp):
    tasks = [pkg.SweepTask(id=i, lr=1e-3, seed=i) for i in range(2)]
    ck = str(tmp / "sweep")
    first = pkg.run_sweep(model, tasks, batch_fn=bf, steps=3, max_pack=2,
                          checkpoint_dir=ck,
                          early_stop=lambda t, s, l: t.id == 1 and s >= 0)
    assert len(first.losses[0]) == 3 and len(first.losses[1]) == 1
    again = pkg.run_sweep(model, tasks, batch_fn=bf, steps=3, max_pack=2,
                          checkpoint_dir=ck)
    assert all(len(v) == 0 for v in again.losses.values())
    assert again.lane_steps == 0
    return [first, again]


def periodic_checkpoints(pkg, model, bf, tmp):
    tasks = [pkg.SweepTask(id=0, lr=1e-3, seed=0)]
    ck = str(tmp / "sweep")
    res = pkg.run_sweep(model, tasks, batch_fn=bf, steps=5, max_pack=1,
                        checkpoint_dir=ck,
                        policy=pkg.FaultPolicy(checkpoint_every=2))
    saved = sorted(os.listdir(f"{ck}/task_0"))
    assert "step_0000000002" in saved and "step_0000000005" in saved
    with pytest.raises(ZeroDivisionError):
        pkg.run_sweep(model, tasks, batch_fn=bf, steps=3, max_pack=1,
                      early_stop=lambda t, s, l: 1 / 0)
    return [res]


def _preempt_resume(resume_pack):
    def scenario(pkg, model, bf, tmp):
        tasks = lambda: [pkg.SweepTask(id=i, lr=1e-3, seed=i)
                         for i in range(4)]
        base = pkg.run_sweep(model, tasks(), batch_fn=bf, steps=4,
                             max_pack=4)
        ck = str(tmp / "sweep")
        part = pkg.run_sweep(model, tasks(), batch_fn=bf, steps=4,
                             max_pack=4, checkpoint_dir=ck,
                             preempt=lambda st: st.global_steps >= 2)
        assert part.preempted
        assert all(len(v) == 2 for v in part.losses.values())
        res = pkg.run_sweep(model, tasks(), batch_fn=bf, steps=4,
                            max_pack=resume_pack, checkpoint_dir=ck)
        assert not res.preempted
        for i in range(4):
            assert np.float32(part.losses[i] + res.losses[i]).tolist() == \
                np.float32(base.losses[i]).tolist(), i
        with pytest.raises(ValueError, match="checkpoint_dir"):
            pkg.run_sweep(model, tasks()[:1], batch_fn=bf, steps=2,
                          preempt=lambda st: True)
        return [base, part, res]
    return scenario


def adaptive_pack(pkg, model, bf, tmp):
    tasks = lambda: [pkg.SweepTask(id=i, lr=1e-3, seed=i) for i in range(6)]
    base = pkg.run_sweep(model, tasks(), batch_fn=bf, steps=4, max_pack=6)
    ad = pkg.run_sweep(model, tasks(), batch_fn=bf, steps=4, max_pack=6,
                       adaptive_pack=True,
                       repack_policy=pkg.RepackPolicy(
                           start_capacity=2, grow_occupancy=0.5,
                           shrink_occupancy=0.1, cooldown_steps=1,
                           max_capacity=6))
    for i in range(6):
        assert np.float32(ad.losses[i]).tolist() == \
            np.float32(base.losses[i]).tolist(), i
    assert ad.repacks >= 1
    assert ad.capacity_trace[-1][1] == ad.pack_factor == 6
    assert ad.lane_steps == base.lane_steps
    return [base, ad]


SCENARIOS = {"parametric": parametric, "skewed": skewed,
             "early_stop": early_stop, "checkpoint_resume": checkpoint_resume,
             "periodic_checkpoints": periodic_checkpoints,
             "preempt_resume_4": _preempt_resume(4),
             "preempt_resume_2": _preempt_resume(2),
             "adaptive_pack": adaptive_pack}


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

class _OneWeight:
    """The reference's model interface (``init``, ``loss``) over one f32
    weight vector: its step compiles in a fraction of a second."""
    cfg = types.SimpleNamespace(vocab_size=256)

    def init(self, key):
        return {"w": jax.random.normal(key, (3,))}

    def loss(self, params, batch):
        x = batch["tokens"].astype(jnp.float32).mean() / 256.0
        loss = jnp.sum((params["w"] - x) ** 2)
        return loss, {"loss": loss}


@pytest.fixture(scope="module")
def ref_counters(tmp_path_factory):
    """The reference's ``SweepResult`` counters of a scenario, each run
    once."""
    cache: dict = {}

    def get(name):
        if name not in cache:
            results = SCENARIOS[name](REF, _OneWeight(),
                                      _batch_fn(_OneWeight.cfg.vocab_size),
                                      tmp_path_factory.mktemp(name))
            cache[name] = [_counters(r) for r in results]
        return cache[name]
    return get


def _counters(res):
    return {k: getattr(res, k) for k in COUNTERS}


@pytest.fixture(scope="module", params=ARCHS)
def ref_model(request):
    cfg = jconfigs.get(request.param).reduced()
    return request.param, jbuild(cfg, JCtx(moe_oracle=True))


@pytest.fixture(scope="module")
def oracle(ref_model):
    """The reference's per-task losses of every (lr, seed) in ``ORACLE``,
    from one sweep of ``ORACLE_STEPS`` steps."""
    _, jm = ref_model
    tasks = [JSweepTask(id=i, lr=lr, seed=s)
             for i, (lr, s) in enumerate(ORACLE)]
    res = jrun_sweep(jm, tasks, batch_fn=_batch_fn(jm.cfg.vocab_size),
                     steps=ORACLE_STEPS, max_pack=len(tasks))
    return {key: res.losses[i] for i, key in enumerate(ORACLE)}


def shared_init_model(jm, cfg, pctx=None, cls=Model):
    """The port's ``cls`` (a ``Model``) whose ``init(generator)`` is the
    reference's ``init(PRNGKey(generator.initial_seed()))``."""
    init = jax.jit(jm.init)
    cache: dict = {}

    class Shared(cls):
        def init(self, generator):
            seed = generator.initial_seed()
            if seed not in cache:
                cache[seed] = jax.tree_util.tree_map(
                    np.asarray, init(jax.random.PRNGKey(seed)))
            return params_from_numpy(cache[seed], self.device)
    return Shared(cfg, pctx, device="cpu")


# ---------------------------------------------------------------------------
# the port against it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_run_sweep_matches_reference(ref_model, oracle, ref_counters, name,
                                     impl, tmp_path):
    arch, jm = ref_model
    cfg = configs.get(arch).reduced()
    model = shared_init_model(jm, cfg, ParallelCtx(attn_impl=impl))
    results = SCENARIOS[name](PORT, model, _batch_fn(cfg.vocab_size),
                              tmp_path)
    assert [_counters(r) for r in results] == ref_counters(name)
    lr_of = (dict(enumerate(PARAM_LRS)) if name == "parametric"
             else {})
    for res in results:
        for i, losses in res.losses.items():
            want = oracle[(lr_of.get(i, 1e-3), i)]
            start = 0
            if name.startswith("preempt") and res is results[2]:
                start = 2               # the resumed half of the run
            np.testing.assert_allclose(
                losses, want[start:start + len(losses)], **TOL,
                err_msg=f"{name} task {i}")


class _FailsOnce(Model):
    """A model whose loss raises ``TaskOOM`` on one call (the vmapped step
    calls it once a pool step): the masked step fails pool-wide."""
    fail_on = 3

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.loss = inject_failures(super().loss,
                                    oom_on_calls=(self.fail_on,))


def test_oom_backoff_halves_the_pool_and_reruns_unfinished_tasks(ref_model):
    """A ``PoolStepError`` at capacity 4 (the third pool step) halves the
    pool to 2; the unfinished tasks restart from step 0 (no checkpoint)
    and their losses are those of the uninterrupted run."""
    arch, jm = ref_model
    cfg = configs.get(arch).reduced()
    bf = _batch_fn(cfg.vocab_size)
    tasks = lambda: [SweepTask(id=i, lr=1e-3, seed=i) for i in range(4)]
    want = run_sweep(shared_init_model(jm, cfg), tasks(), batch_fn=bf,
                     steps=4, max_pack=4)
    got = run_sweep(shared_init_model(jm, cfg, cls=_FailsOnce), tasks(),
                    batch_fn=bf, steps=4, max_pack=4)
    assert got.backoffs == 1 and got.pack_factor == 2
    assert got.lane_steps == want.lane_steps == 16
    assert got.global_steps == 8 and got.n_traces == 2
    for i in range(4):
        assert np.float32(got.losses[i]).tolist() == \
            np.float32(want.losses[i]).tolist(), i
    with pytest.raises(PoolStepError):
        run_sweep(shared_init_model(jm, cfg, cls=_FailsOnce), tasks(),
                  batch_fn=bf, steps=4, max_pack=4,
                  policy=FaultPolicy(oom_backoff=False))
