"""The port's lane pool: the pool-side cases of tests/test_lanepool.py on
the port (masked-step semantics, detach/re-attach, build-once, refill,
the three execution modes), one attach/detach schedule through both
packages' pools, drain to a ``PoolSnapshot`` and rehydrate at another
capacity, repacking through a policy object, a ``RepackController`` and a
bare ``RepackPolicy`` (tests/test_repack.py's executor cases), and the
checkpoint layout.

Where the reference asserts bit-identity inside one package, the port
asserts it too (``torch.equal`` / ``assert_array_equal``). Across the two
packages per-task losses agree at rtol = 1e-5, atol = 1e-6 (f32; XLA and
PyTorch sum in other orders) and the ``RefillStats`` counters are equal.
"where" vs "kernel" is allclose at rtol = atol = 2e-5, the reference's own
bound for a step that runs another program (bench_kernels.py:124).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import kernel_pool_step, lane_step, occupancy_mask
from repro import optim as joptim
from repro.core import lanepool as jlp
from repro_torch import optim
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.core import packing
from repro_torch.core.lanepool import (LanePool, LaneTask, PoolSnapshot,
                                       PoolStepError, RefillExecutor,
                                       rehydrate, run_waves)
from repro_torch.core.repack import RepackController, RepackPolicy
from repro_torch.data.mnist import synthetic_mnist
from repro_torch.models import lenet
from tests.prop import given_cases

XPKG_TOL = dict(rtol=1e-5, atol=1e-6)
MODE_TOL = dict(rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the reference's tiny model, on both packages, from numpy
# ---------------------------------------------------------------------------

def _init_np(seed):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.standard_normal((8, 16)) * 0.1).astype(np.float32),
            "w2": (rng.standard_normal((16, 4)) * 0.1).astype(np.float32)}


def _init(seed):
    return {k: torch.from_numpy(v) for k, v in _init_np(seed).items()}


def _loss(params, batch):
    h = torch.tanh(batch["x"] @ params["w1"])
    return torch.mean((h @ params["w2"] - batch["y"]) ** 2)


def _batch(seed, step, n=16):
    rng = np.random.Generator(np.random.Philox(key=seed,
                                               counter=[step, 0, 0, 0]))
    x = rng.standard_normal((n, 8)).astype(np.float32)
    return {"x": x, "y": (x[:, :4] * 0.5).astype(np.float32)}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _step_fn(loss, opt):
    def step(params, opt_state, batch, lr):
        g, l = torch.func.grad_and_value(loss)(params, batch)
        upd, opt_state = opt.update(g, opt_state, params, lr)
        return optim.apply_updates(params, upd), opt_state, {"loss": l}
    return step


def _setup():
    opt = optim.sgd()
    return opt, _step_fn(_loss, opt)


def _pool(step, opt, capacity, mode="where", init=_init):
    tmpl = init(0)
    return LanePool(capacity, step, template_params=tmpl,
                    template_opt=opt.init(tmpl),
                    template_hparams=torch.tensor(0.0), exec_mode=mode)


def _lane_task(opt, i, steps, lr=1e-2, init=_init, batch=_batch):
    return LaneTask(id=i, hparams=torch.tensor(lr),
                    init_fn=lambda: (lambda p: (p, opt.init(p)))(init(i)),
                    batch_fn=lambda s, i=i: batch(i, s), steps=steps)


def _run_collect(tasks, pool, **kw):
    losses = {}
    ex = RefillExecutor(pool, on_metrics=lambda t, s, m: losses.setdefault(
        t.id, []).append(float(m["loss"])) and False, **kw)
    stats = ex.run(tasks)
    return losses, stats, ex


def _assert_losses_equal(a, b):
    assert set(a) == set(b)
    for tid in a:
        np.testing.assert_array_equal(np.float32(a[tid]), np.float32(b[tid]))


# ---------------------------------------------------------------------------
# masked-step semantics
# ---------------------------------------------------------------------------

def test_masked_step_freezes_inactive_lanes_bit_identical():
    opt, step = _setup()
    K = 3
    params = packing.stack_trees([_init(s) for s in range(K)])
    opt_state = packing.stack_trees([opt.init(_init(s)) for s in range(K)])
    lrs = torch.full((K,), 1e-2)
    batch = packing.stack_trees([_tbatch(_batch(i, 0)) for i in range(K)])
    masked = packing.packed_masked_step(step)
    new_p, _, _ = masked(params, opt_state, batch, lrs,
                         np.array([True, False, True]))
    ref_p, _, _ = packing.packed_step(step)(params, opt_state, batch, lrs)
    for k in params:
        assert torch.equal(new_p[k][1], params[k][1])
        assert torch.equal(new_p[k][0], ref_p[k][0])
        assert torch.equal(new_p[k][2], ref_p[k][2])


def test_tree_lane_swap_roundtrip():
    trees = [{"a": torch.arange(3) + i, "b": torch.ones(2, 2) * i}
             for i in range(4)]
    stacked = packing.stack_trees(trees)
    swapped = packing.tree_set_lane(stacked, 0,
                                    packing.tree_copy(
                                        packing.tree_get_lane(stacked, 2)))
    back = packing.tree_get_lane(swapped, 0)
    assert torch.equal(back["a"], trees[2]["a"])
    assert torch.equal(back["b"], trees[2]["b"])
    assert torch.equal(packing.tree_get_lane(swapped, 1)["a"], trees[1]["a"])


def test_detach_returns_a_copy_a_later_attach_cannot_change():
    opt, step = _setup()
    pool = _pool(step, opt, 2)
    t = _lane_task(opt, 3, 4)
    pool.attach(0, 3, *t.init_fn(), t.hparams)
    params, _ = pool.detach(0)
    kept = packing.tree_copy(params)
    pool.attach(0, 4, *_lane_task(opt, 4, 4).init_fn(), torch.tensor(0.5))
    for k in kept:
        assert torch.equal(params[k], kept[k])


# ---------------------------------------------------------------------------
# lifecycle: detach/re-attach equivalence
# ---------------------------------------------------------------------------

def test_detach_reattach_on_other_lane_bit_identical():
    opt, step = _setup()
    STEPS = 6
    ref_losses, _, _ = _run_collect(
        [_lane_task(opt, 7, STEPS), _lane_task(opt, 8, STEPS)],
        _pool(step, opt, 2))

    pool2 = _pool(step, opt, 2)
    t7 = _lane_task(opt, 7, STEPS)
    pool2.attach(0, 7, *t7.init_fn(), t7.hparams)
    pool2.attach(1, 9, *_lane_task(opt, 9, STEPS).init_fn(),
                 torch.tensor(1e-2))
    got = []
    for s in range(3):
        m = pool2.step(packing.stack_trees([_tbatch(_batch(7, s)),
                                            _tbatch(_batch(9, s))]))
        got.append(float(m["loss"][0]))
    mid_state = pool2.detach(0)
    pool2.attach(0, 5, *_lane_task(opt, 5, STEPS).init_fn(),
                 torch.tensor(3e-2))   # a NEW neighbour takes lane 0
    pool2.detach(1)
    pool2.attach(1, 7, *mid_state, t7.hparams)   # task 7 now on lane 1
    for s in range(3, STEPS):
        m = pool2.step(packing.stack_trees([_tbatch(_batch(5, s)),
                                            _tbatch(_batch(7, s))]))
        got.append(float(m["loss"][1]))
    np.testing.assert_array_equal(np.float32(ref_losses[7]), np.float32(got))
    assert pool2.n_traces == 1


# ---------------------------------------------------------------------------
# build-once guarantee
# ---------------------------------------------------------------------------

def test_skewed_sweep_3x_capacity_traces_once():
    opt, step = _setup()
    CAP = 3
    tasks = [_lane_task(opt, i, steps=2 + (5 * i) % 7)
             for i in range(3 * CAP)]
    losses, stats, _ = _run_collect(tasks, _pool(step, opt, CAP))
    assert stats.n_traces == 1
    assert stats.attaches == 3 * CAP
    for i in range(3 * CAP):
        assert len(losses[i]) == 2 + (5 * i) % 7


@pytest.mark.parametrize("waves", [False, True])
def test_a_finished_lanes_state_is_freed_before_the_next_step(waves):
    """The copy of a finished lane's state that ``on_finish`` receives is
    dropped once the callback returns: nothing holds it through the next
    refill and step (at a full-width model it is a lane's whole state)."""
    import weakref

    from repro_torch.core.lanepool import run_waves
    opt, step = _setup()
    held, alive_at_step = [], []

    def on_finish(t, params, opt_state):
        held.append(weakref.ref(params["w1"]))

    def counted(*args):
        alive_at_step.append(sum(r() is not None for r in held))
        return step(*args)
    tasks = [_lane_task(opt, i, steps=1 + i % 3) for i in range(5)]
    if waves:
        run_waves(lambda: _pool(counted, opt, 2), tasks, on_finish=on_finish)
    else:
        RefillExecutor(_pool(counted, opt, 2),
                       on_finish=on_finish).run(tasks)
    assert len(held) == 5 and len(alive_at_step) > 1
    assert alive_at_step == [0] * len(alive_at_step)
    assert all(r() is None for r in held)


def test_refill_beats_waves_on_skewed_budgets():
    opt, step = _setup()
    CAP = 3
    mk = lambda: [_lane_task(opt, i, steps=1 + (4 * i) % 9) for i in range(9)]
    wave = run_waves(lambda: _pool(step, opt, CAP), mk())
    refill = RefillExecutor(_pool(step, opt, CAP)).run(mk())
    assert wave.lane_steps == refill.lane_steps
    assert refill.global_steps < wave.global_steps
    assert refill.occupancy > wave.occupancy


@given_cases(n=15, seed=3)
def test_refill_never_runs_two_tasks_on_one_lane(rng):
    opt, step = _setup()
    cap = int(rng.integers(1, 4))
    n_tasks = int(rng.integers(1, 9))
    tasks = [_lane_task(opt, i, steps=int(rng.integers(1, 6)))
             for i in range(n_tasks)]
    budgets = {t.id: t.steps for t in tasks}
    ex = RefillExecutor(_pool(step, opt, cap), record_history=True)
    stats = ex.run(tasks)
    seen, per_task = {}, {}
    for g, lane, tid in ex.history:
        assert (g, lane) not in seen, \
            f"lane {lane} ran tasks {seen[(g, lane)]} and {tid} at step {g}"
        seen[(g, lane)] = tid
        per_task[tid] = per_task.get(tid, 0) + 1
    assert per_task == budgets
    assert stats.lane_steps == sum(budgets.values())


def test_pool_step_failure_raises_poolsteperror_but_callbacks_raw():
    opt, step = _setup()
    pool = _pool(step, opt, 2)
    t = _lane_task(opt, 0, 2)
    pool.attach(0, 0, *t.init_fn(), t.hparams)
    bad = {"x": torch.zeros(2, 16, 5), "y": torch.zeros(2, 16, 4)}
    with pytest.raises(PoolStepError):
        pool.step(bad)
    ex = RefillExecutor(_pool(step, opt, 2), on_metrics=lambda t, s, m: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        ex.run([_lane_task(opt, 0, 2)])


def test_refill_periodic_checkpoint_hook():
    opt, step = _setup()
    saved = []
    ex = RefillExecutor(_pool(step, opt, 2), checkpoint_every=2,
                        on_checkpoint=lambda t, p, o: saved.append(
                            (t.id, t.step_done)))
    ex.run([_lane_task(opt, 0, 5), _lane_task(opt, 1, 2)])
    assert saved == [(0, 2), (0, 4)]


def test_attach_occupied_lane_raises():
    opt, step = _setup()
    pool = _pool(step, opt, 2)
    t = _lane_task(opt, 0, 2)
    pool.attach(0, 0, *t.init_fn(), t.hparams)
    with pytest.raises(RuntimeError, match="already occupied"):
        pool.attach(0, 1, *t.init_fn(), t.hparams)
    with pytest.raises(RuntimeError, match="not occupied"):
        pool.detach(1)


# ---------------------------------------------------------------------------
# masked execution modes: where / compact / kernel
# ---------------------------------------------------------------------------

def test_compact_mode_bit_identical_through_refill():
    opt, step = _setup()
    CAP = 4
    mk = lambda: [_lane_task(opt, i, steps=1 + (5 * i) % 7)
                  for i in range(3 * CAP)]
    ref_losses, ref_stats, _ = _run_collect(mk(), _pool(step, opt, CAP))
    got_losses, got_stats, _ = _run_collect(mk(),
                                            _pool(step, opt, CAP, "compact"))
    _assert_losses_equal(ref_losses, got_losses)
    assert ref_stats.lane_steps == got_stats.lane_steps
    assert got_stats.n_traces <= 3   # buckets {1, 2, 4} at capacity 4


def test_compact_mode_traces_once_per_occupancy_bucket():
    opt, step = _setup()
    pool = _pool(step, opt, 4, "compact")
    tasks = [_lane_task(opt, i, 99) for i in range(4)]
    batch = packing.stack_trees([_tbatch(_batch(i, 0)) for i in range(4)])
    for n, want in ((1, 1), (2, 2), (3, 3), (4, 3)):  # buckets 1,2,4,4
        for lane in range(n - 1 if n > 1 else 0, n):
            if lane not in pool.active_lanes():
                pool.attach(lane, n * 10 + lane, *tasks[lane].init_fn(),
                            tasks[lane].hparams)
        pool.step(batch)
        assert pool.n_traces == want, (n, pool.n_traces)
    pool.detach(3)
    pool.step(batch)
    pool.detach(2)
    pool.step(batch)
    assert pool.n_traces == 3


def test_kernel_mode_pool_freezes_inactive_lanes():
    J, nb, d = 3, 8, 16
    rng = np.random.default_rng(2)
    tmpl = {"w": torch.from_numpy(
        (rng.standard_normal((d, d)) * 0.1).astype(np.float32))}
    pool = LanePool(J, kernel_pool_step, template_params=tmpl,
                    template_opt={"m": torch.tensor(0.0)},
                    template_hparams=torch.tensor(0.0), exec_mode="kernel")
    lane_p = {"w": torch.from_numpy(
        (rng.standard_normal((d, d)) * 0.1).astype(np.float32))}
    pool.attach(0, 0, lane_p, {"m": torch.tensor(0.0)}, torch.tensor(1e-2))
    pool.attach(2, 2, {"w": lane_p["w"] + 0.5}, {"m": torch.tensor(0.0)},
                torch.tensor(1e-2))
    before = packing.tree_copy(pool.params)
    batch = {"x": torch.from_numpy(rng.standard_normal((J, nb, d)).astype(
        np.float32)), "y": torch.zeros(J, nb, d)}
    pool.step(batch)
    assert torch.equal(pool.params["w"][1], before["w"][1])
    dense_step = packing.packed_kernel_step(kernel_pool_step)
    dense_p, _, _ = dense_step(before, {"m": torch.zeros(J)}, batch,
                               torch.full((J,), 1e-2), torch.ones(J))
    for lane in (0, 2):
        assert torch.equal(pool.params["w"][lane], dense_p["w"][lane])
    assert pool.n_traces == 1


def _mode_inputs(J, d, o, nb, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    return ({"w": mk(J, d, o)}, {"m": torch.zeros(J)}, torch.full((J,), 1e-2),
            {"x": mk(J, nb, d), "y": mk(J, nb, o)})


@pytest.mark.parametrize("occ", [0.25, 0.5, 0.75, 1.0])
def test_three_modes_agree(occ):
    """bench_kernels.py::check_masked_modes on the port: where == compact
    bit for bit; kernel masked == kernel dense on active lanes; kernel vs
    where allclose (another program); inactive state untouched."""
    J = 4
    params, opt, hp, batch = _mode_inputs(J, 16, 8, 8, seed=0)
    where = packing.masked_pool_step(lane_step, mode="where")
    compact = packing.masked_pool_step(lane_step, mode="compact")
    kernel = packing.masked_pool_step(kernel_pool_step, mode="kernel")
    mask = occupancy_mask(J, occ, seed=int(occ * 100))
    act, inact = np.flatnonzero(mask), np.flatnonzero(~mask)
    wp, _, wm = where(params, opt, batch, hp, mask)
    cp, _, cm = compact(params, opt, batch, hp, mask)
    kp, _, km = kernel(params, opt, batch, hp, mask)
    kd, _, kmd = kernel(params, opt, batch, hp, np.ones((J,), bool))
    assert torch.equal(wm["loss"][act], cm["loss"][act])
    assert torch.equal(wp["w"], cp["w"])
    assert torch.equal(kp["w"][act], kd["w"][act])
    assert torch.equal(km["loss"][act], kmd["loss"][act])
    np.testing.assert_allclose(kp["w"][act].numpy(), wp["w"][act].numpy(),
                               **MODE_TOL)
    if inact.size:
        assert torch.equal(cp["w"][inact], params["w"][inact])
        assert torch.equal(kp["w"][inact], params["w"][inact])
        assert torch.equal(cm["loss"][inact], torch.zeros(inact.size))


@given_cases(n=10, seed=11)
def test_exec_modes_agree_random_lifecycle(rng):
    opt, step = _setup()
    cap = int(rng.integers(2, 5))
    n_tasks = int(rng.integers(cap, 2 * cap + 1))
    steps = [int(rng.integers(1, 5)) for _ in range(n_tasks)]
    mk = lambda: [_lane_task(opt, i, steps=steps[i]) for i in range(n_tasks)]
    a, _, _ = _run_collect(mk(), _pool(step, opt, cap, "where"))
    b, _, _ = _run_collect(mk(), _pool(step, opt, cap, "compact"))
    _assert_losses_equal(a, b)


# ---------------------------------------------------------------------------
# LeNet-4 on the pool: the paper's tasks
# ---------------------------------------------------------------------------

def _lenet_init(seed):
    return lenet.init(torch.Generator().manual_seed(seed), device="cpu")


def _lenet_batch(seed, step):
    return synthetic_mnist(8, step, seed=seed)


def _lenet_tasks(opt, budgets):
    return [_lane_task(opt, i, b, lr=0.01 * (1 + i % 4), init=_lenet_init,
                       batch=_lenet_batch) for i, b in enumerate(budgets)]


def test_lenet_where_and_compact_bit_identical_through_refill():
    """Buckets of 1, 2 and 4 lanes all occur; a one-lane bucket runs as two
    copies of the lane (a one-lane vmap differs in LeNet's last bits)."""
    opt = optim.sgd()
    step = _step_fn(lenet.loss, opt)
    budgets = [3, 1, 4, 2, 5, 1]
    a, sa, _ = _run_collect(_lenet_tasks(opt, budgets),
                            _pool(step, opt, 4, "where", _lenet_init))
    b, sb, _ = _run_collect(_lenet_tasks(opt, budgets),
                            _pool(step, opt, 4, "compact", _lenet_init))
    _assert_losses_equal(a, b)
    assert sa.lane_steps == sb.lane_steps == sum(budgets)
    assert sa.n_traces == 1 and sb.n_traces == 3


@pytest.mark.parametrize("resume_cap", [2, 6])
def test_snapshot_save_load_rehydrate_at_other_capacity(tmp_path, resume_cap):
    """Preempt a 4-lane LeNet run at global step 3, persist the snapshot,
    load it, resume at another capacity: per-task losses are bit-identical
    to the uninterrupted run."""
    opt = optim.sgd()
    step = _step_fn(lenet.loss, opt)
    budgets = [5, 2, 6, 4, 3, 5, 2]
    want, _, _ = _run_collect(_lenet_tasks(opt, budgets),
                              _pool(step, opt, 4, "where", _lenet_init))

    first, stats1, ex1 = _run_collect(
        _lenet_tasks(opt, budgets), _pool(step, opt, 4, "where", _lenet_init),
        should_preempt=lambda st: st.global_steps == 3)
    assert stats1.preempted and ex1.snapshot.lanes
    ex1.snapshot.save(str(tmp_path), step=3)
    tmpl = _lenet_init(0)
    snap = PoolSnapshot.load(str(tmp_path), tmpl, opt.init(tmpl),
                             torch.tensor(0.0))
    assert snap.capacity == 4 and snap.queued == ex1.snapshot.queued
    assert [r.task_id for r in snap.lanes] == \
        [r.task_id for r in ex1.snapshot.lanes]
    tasks = rehydrate(snap, _lenet_tasks(opt, budgets))
    rest, stats2, _ = _run_collect(
        tasks, _pool(step, opt, resume_cap, "where", _lenet_init))
    got = {tid: first.get(tid, []) + rest.get(tid, []) for tid in want}
    _assert_losses_equal(want, got)
    assert stats1.lane_steps + stats2.lane_steps == sum(budgets)


class _GrowAt:
    """A repack policy object: grow the pool to ``cap`` at ``step``."""

    def __init__(self, step, cap):
        self.step, self.cap, self.seen = step, cap, []

    def observe(self, global_step, n_attached, capacity, queue_len):
        self.seen.append((global_step, n_attached, capacity, queue_len))

    def decide(self, global_step, capacity, queue_len, live):
        return self.cap if global_step == self.step else None


def test_repack_policy_object_resizes_bit_identically():
    opt, step = _setup()
    mk = lambda: [_lane_task(opt, i, steps=2 + i % 4) for i in range(8)]
    want, _, _ = _run_collect(mk(), _pool(step, opt, 2))
    policy = _GrowAt(2, 4)
    got, stats, ex = _run_collect(mk(), _pool(step, opt, 2),
                                  repack_policy=policy)
    _assert_losses_equal(want, got)
    assert stats.repacks == 1 and stats.capacity_trace == [(2, 4)]
    assert ex.pool.capacity == 4 and stats.n_traces == 2
    assert policy.seen[0] == (1, 2, 2, 6)


REPACK_BUDGETS = [3, 7, 4, 6, 2, 5, 8, 3, 5, 4]   # tests/test_repack.py


def _repack_tasks(opt):
    return [_lane_task(opt, i, b) for i, b in enumerate(REPACK_BUDGETS)]


def test_executor_grow_and_shrink_bit_identical():
    """tests/test_repack.py::test_executor_grow_and_shrink_bit_identical:
    a RepackController resizes the pool mid-run; per-task losses are
    bit-identical to a fixed pool's, and the traces sum over capacities."""
    opt, step = _setup()
    want, _, _ = _run_collect(_repack_tasks(opt), _pool(step, opt, 2))
    ctl = RepackController(RepackPolicy(
        grow_occupancy=0.5, shrink_occupancy=0.3, cooldown_steps=2,
        max_capacity=8), measure_bytes=lambda: 0)
    got, stats, _ = _run_collect(_repack_tasks(opt), _pool(step, opt, 2),
                                 repack_policy=ctl)
    _assert_losses_equal(want, got)
    assert stats.repacks >= 1
    assert stats.capacity_trace == ctl.capacity_trace()
    assert stats.n_traces == len({2} | {c for _, c in stats.capacity_trace})
    assert stats.lane_steps == sum(REPACK_BUDGETS)


def test_executor_accepts_bare_policy():
    """tests/test_repack.py::test_executor_accepts_bare_policy: a bare
    RepackPolicy is wrapped in a private RepackController."""
    opt, step = _setup()
    want, _, _ = _run_collect(_repack_tasks(opt), _pool(step, opt, 2))
    got, stats, ex = _run_collect(
        _repack_tasks(opt), _pool(step, opt, 2),
        repack_policy=RepackPolicy(grow_occupancy=0.5, shrink_occupancy=0.0,
                                   cooldown_steps=1, max_capacity=4))
    _assert_losses_equal(want, got)
    assert stats.repacks >= 1
    assert isinstance(ex.repack, RepackController)


def test_speculative_twin_finishes_once():
    opt, step = _setup()
    finished = []
    ex = RefillExecutor(_pool(step, opt, 3), speculative=True,
                        stragglers_fn=lambda: [0],
                        on_finish=lambda t, p, o: finished.append(t.id))
    stats = ex.run([_lane_task(opt, 0, 4), _lane_task(opt, 1, 2)])
    assert sorted(finished) == [0, 1]
    assert stats.spec_attaches == 1 and stats.spec_cancelled == 1
    assert stats.lane_steps == 6


# ---------------------------------------------------------------------------
# one schedule through both packages
# ---------------------------------------------------------------------------

def _j_loss(params, batch):
    h = jnp.tanh(batch["x"] @ params["w1"])
    return jnp.mean((h @ params["w2"] - batch["y"]) ** 2)


def _j_step(opt):
    def step(params, opt_state, batch, lr):
        l, g = jax.value_and_grad(_j_loss)(params, batch)
        upd, opt_state = opt.update(g, opt_state, params, lr)
        return joptim.apply_updates(params, upd), opt_state, {"loss": l}
    return step


@pytest.mark.parametrize("mode", ["where", "compact"])
def test_same_schedule_through_both_pools(mode):
    """One attach/detach schedule (skewed budgets, refill, an early stop)
    through the reference's LanePool and the port's: per-task losses agree
    and every RefillStats counter is equal."""
    budgets = [3, 1, 5, 2, 4, 2, 3]
    lrs = [1e-2, 3e-2, 5e-2, 2e-2, 1e-2, 4e-2, 2e-2]
    stop_at = {2: 3}                               # task 2 stops early

    jopt = joptim.sgd()
    jtmpl = {k: jnp.asarray(v) for k, v in _init_np(0).items()}
    jpool = jlp.LanePool(3, _j_step(jopt), template_params=jtmpl,
                         template_opt=jopt.init(jtmpl),
                         template_hparams=jnp.float32(0.0), exec_mode=mode)
    jtasks = [jlp.LaneTask(
        id=i, hparams=jnp.float32(lrs[i]),
        init_fn=lambda i=i: (lambda p: (p, jopt.init(p)))(
            {k: jnp.asarray(v) for k, v in _init_np(i).items()}),
        batch_fn=lambda s, i=i: _batch(i, s), steps=b)
        for i, b in enumerate(budgets)]
    opt, step = _setup()
    tasks = [_lane_task(opt, i, b, lr=lrs[i]) for i, b in enumerate(budgets)]

    def collect(store):
        def on_metrics(t, s, m):
            store.setdefault(t.id, []).append(float(np.asarray(m["loss"])))
            return stop_at.get(t.id) == s + 1
        return on_metrics

    want, got = {}, {}
    jstats = jlp.RefillExecutor(jpool, on_metrics=collect(want)).run(jtasks)
    stats = RefillExecutor(_pool(step, opt, 3, mode),
                           on_metrics=collect(got)).run(tasks)
    assert set(got) == set(want)
    for tid in want:
        np.testing.assert_allclose(got[tid], want[tid], **XPKG_TOL)
    for field in ("global_steps", "lane_steps", "attaches", "n_traces",
                  "preempted", "repacks", "spec_attaches"):
        assert getattr(stats, field) == getattr(jstats, field), field
    assert tasks[2].stopped_early and jtasks[2].stopped_early


# ---------------------------------------------------------------------------
# checkpoint layout
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_keeps_dtypes_and_layout(tmp_path):
    tree = {"b": {"w": torch.randn(3, 4).to(torch.bfloat16),
                  "count": torch.tensor(7, dtype=torch.int32)},
            "a": torch.arange(5, dtype=torch.float32)}
    path = ck.save_checkpoint(str(tmp_path), tree, 12, {"note": "x"})
    assert path.endswith("step_0000000012")
    names = sorted(p.name for p in (tmp_path / "step_0000000012").iterdir())
    assert names[0].startswith("0000__") and "manifest.json" in names
    assert ck.latest_step(str(tmp_path)) == 12
    assert ck.load_extra(str(tmp_path)) == ({"note": "x"}, 12)
    like = {"a": torch.zeros(5), "b": {"w": torch.zeros(3, 4,
                                                        dtype=torch.bfloat16),
                                       "count": torch.tensor(0,
                                                             dtype=torch.int32)}}
    back, step, extra = ck.load_checkpoint(str(tmp_path), like)
    assert step == 12 and extra == {"note": "x"}
    assert torch.equal(back["b"]["w"], tree["b"]["w"])
    assert back["b"]["count"].dtype == torch.int32
    assert torch.equal(back["a"], tree["a"])
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.load_checkpoint(str(tmp_path), {"a": torch.zeros(5)})


def test_checkpointer_async_save_and_retention(tmp_path):
    cp = ck.Checkpointer(str(tmp_path), keep=2)
    t = {"w": torch.ones(4)}
    for s in range(4):
        t["w"] += 1                  # the saved copy must not see this
        cp.save(t, s, blocking=(s % 2 == 0))
    cp.wait()
    steps = sorted(p.name for p in tmp_path.iterdir())
    assert steps == ["step_0000000002", "step_0000000003"]
    back, step, _ = cp.restore({"w": torch.zeros(4)})
    assert step == 3 and torch.equal(back["w"], torch.full((4,), 5.0))
