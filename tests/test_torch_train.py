"""The port's training layer against the JAX reference on the CPU, from the
same numpy inputs and the reference's own parameters: the learning-rate
schedules, ``SyntheticLM`` batches (bit-equal), ``cross_entropy_loss`` with
``ignore_id``, ``Model.loss`` and one ``make_train_step`` for the dense and
ssm families under the "chunked" and "kernel" paths (the kernels' plain
versions here), remat (bit-equal on and off under ``vmap(grad)``, and off
every no-grad path), and ``Trainer.fit`` with a checkpoint and a resume."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import TokenFileDataset as JTokenFileDataset
from repro.launch.train import Trainer as JTrainer
from repro.launch.train import make_train_step as jmake_train_step
from repro.models import ParallelCtx as JCtx, build_model as jbuild
from repro.models import layers as jlayers
from repro.optim import schedule as jschedule
from repro_torch import configs, optim
from repro_torch.core import packing
from repro_torch.data import SyntheticLM, TokenFileDataset, write_token_file
from repro_torch.launch.train import Trainer, make_eval_step, make_train_step
from repro_torch.models import ParallelCtx, build_model, layers, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.optim import schedule

ARCHS = ["stablelm-1.6b", "mamba2-130m"]
IMPLS = ["chunked", "kernel"]
# f32 on both sides, the same algorithm summed in other orders: the
# package-parity bound of the port's model tests on unit-scale values
# (tests/test_torch_model.py) is 1e-4 on logits; a mean loss and a step's
# parameters sit well inside 2e-5 (the f32 parity bound)
TOL = dict(rtol=2e-5, atol=2e-5)
# schedules: XLA's and PyTorch's cos and division round the last f32 bit
# apart
SCHED_TOL = dict(rtol=1e-6, atol=0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference model, its params as numpy, the reduced config)."""
    cfg = jconfigs.get(request.param).reduced()
    jm = jbuild(cfg, JCtx(moe_oracle=True))
    return jm, _np(jax.jit(jm.init)(jax.random.PRNGKey(0))), request.param


def _batch(vocab, seed, step=0, seq=16, batch=2):
    return SyntheticLM(vocab_size=vocab, seq_len=seq, batch_size=batch,
                       seed=seed).batch(step)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# schedules and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.constant(3e-3),
    lambda m: m.cosine_decay(1e-3, 10),
    lambda m: m.cosine_decay(2e-3, 7, final_frac=0.0),
    lambda m: m.linear_warmup_cosine(1e-3, 3, 12),
    lambda m: m.linear_warmup_cosine(2e-3, 0, 5, final_frac=0.0)],
    ids=["constant", "cosine", "cosine_to_zero", "warmup_cosine",
         "no_warmup"])
def test_schedule_matches_reference(make):
    got = [make(schedule)(s) for s in range(15)]
    assert all(g.dtype == torch.float32 and g.shape == () for g in got)
    want = [np.float32(make(jschedule)(s)) for s in range(15)]
    np.testing.assert_allclose(np.float32([float(g) for g in got]),
                               np.float32(want), **SCHED_TOL)


@pytest.mark.parametrize("vocab,seq,batch,seed,step,shard", [
    (256, 16, 2, 0, 0, 0), (256, 32, 4, 3, 7, 0), (100352, 512, 2, 5, 2, 1),
    (50280, 40, 3, 11, 0, 2)])
def test_synthetic_lm_batches_bit_equal(vocab, seq, batch, seed, step, shard):
    kw = dict(vocab_size=vocab, seq_len=seq, batch_size=batch, seed=seed,
              shard=shard, num_shards=3)
    got = SyntheticLM(**kw).batch(step)
    want = JSyntheticLM(**kw).batch(step)
    assert sorted(got) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_token_file_dataset_bit_equal(tmp_path):
    path = str(tmp_path / "tokens.bin")
    write_token_file(path, np.arange(5000) % 977)
    for shard in (0, 1):
        got = TokenFileDataset(path, 64, 2, shard=shard, num_shards=2)
        want = JTokenFileDataset(path, 64, 2, shard=shard, num_shards=2)
        for step in (0, 5, 30):
            for k, v in want.batch(step).items():
                np.testing.assert_array_equal(got.batch(step)[k], v)
        it = iter(got)
        first = next(it)
        np.testing.assert_array_equal(first["tokens"],
                                      want.batch(0)["tokens"])
        it.close()


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", ["none", "some", "all"])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 9, 300)) * 3).astype(np.float32)
    labels = rng.integers(0, 300, (2, 9)).astype(np.int32)
    if masked == "some":
        labels[0, :4] = -1
        labels[1, -2:] = -1
    elif masked == "all":
        labels[:] = -1
    got = layers.cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    want = jlayers.cross_entropy_loss(jnp.asarray(logits),
                                      jnp.asarray(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                               atol=1e-6)


def test_cross_entropy_custom_ignore_id_and_bf16_logits():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 64)).astype(np.float32)
    labels = rng.integers(0, 64, (3, 7)).astype(np.int32)
    labels[1] = 7
    got = layers.cross_entropy_loss(
        torch.from_numpy(logits).to(torch.bfloat16),
        torch.from_numpy(labels), ignore_id=7)
    want = jlayers.cross_entropy_loss(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels),
        ignore_id=7)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
def test_model_loss_matches_reference(pair, impl):
    jm, np_params, arch = pair
    model = build_model(configs.get(arch).reduced(),
                        ParallelCtx(attn_impl=impl), device="cpu")
    params = params_from_numpy(np_params, "cpu")
    batch = _batch(model.cfg.vocab_size, 1, seq=32, batch=3)
    total, metrics = model.loss(params, _t(batch))
    jtotal, jmetrics = jax.jit(jm.loss)(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        jax.tree_util.tree_map(jnp.asarray, batch))
    assert sorted(metrics) == sorted(jmetrics) == ["aux", "ce", "loss"]
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL)
    assert float(metrics["aux"]) == 0.0 and torch.equal(total,
                                                        metrics["loss"])
    evald = make_eval_step(model)(params, _t(batch))
    assert torch.equal(evald["loss"], metrics["loss"])


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------

STEP_OPTS = (("sgd", True), ("adamw", False))   # (optimizer, check params)


@pytest.fixture(scope="module")
def ref_steps(pair):
    """The reference's one step from its params under each optimizer of
    ``STEP_OPTS``, on the batch ``_batch(vocab, 2)``."""
    jm, np_params, _ = pair
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jb = jax.tree_util.tree_map(jnp.asarray,
                                _batch(jm.cfg.vocab_size, 2))
    out = {}
    for name, _ in STEP_OPTS:
        jopt = getattr(joptim, name)()
        out[name] = _np(jax.jit(jmake_train_step(jm, jopt))(
            jp, jopt.init(jp), jb, jnp.float32(3e-3)))
    return out


@pytest.mark.parametrize("impl", IMPLS)
def test_train_step_matches_reference(pair, ref_steps, impl):
    """One step under SGD: metrics (loss, grad_norm) and the new params.
    Under AdamW the metrics and the first moments: its first update moves
    a weight by lr·g/(|g| + eps), so a weight whose gradient is within a
    few eps of zero moves by an amount the last bits of g decide."""
    _, np_params, arch = pair
    model = build_model(configs.get(arch).reduced(),
                        ParallelCtx(attn_impl=impl), device="cpu")
    batch = _t(_batch(model.cfg.vocab_size, 2))
    for name, check_params in STEP_OPTS:
        opt = getattr(optim, name)()
        params = params_from_numpy(np_params, "cpu")
        p1, o1, m1 = make_train_step(model, opt)(
            params, opt.init(params), batch, torch.tensor(3e-3))
        jp1, jo1, jm1 = ref_steps[name]
        assert sorted(m1) == sorted(jm1) == ["aux", "ce", "grad_norm",
                                             "loss"]
        for k in jm1:
            np.testing.assert_allclose(float(m1[k]), float(jm1[k]), **TOL)
        key = "v" if check_params else "mu"
        got = packing.tree_leaves(o1[key])
        want = jax.tree_util.tree_leaves(jo1[key])
        if check_params:
            got += packing.tree_leaves(p1)
            want += jax.tree_util.tree_leaves(jp1)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **TOL)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _lane_grads(model, n=3, seq=32):
    params = packing.stack_trees([model.init(torch.Generator().manual_seed(s))
                                  for s in range(n)])
    batch = packing.stack_trees([_t(_batch(model.cfg.vocab_size, s, seq=seq))
                                 for s in range(n)])
    grad = torch.func.vmap(torch.func.grad_and_value(model.loss,
                                                     has_aux=True))
    return grad(params, batch)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal_under_vmap_grad(arch, impl, monkeypatch):
    """``cfg.remat`` recomputes each block in the backward: the gradients
    and losses of three lanes are bit-equal with and without it, and the
    remat run goes through the recompute Function (two blocks, once
    each)."""
    cfg = configs.get(arch).reduced()
    calls = []
    real = transformer._Recompute.apply
    monkeypatch.setattr(transformer._Recompute, "apply",
                        lambda *a: calls.append(1) or real(*a))
    out = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat),
                            ParallelCtx(attn_impl=impl), device="cpu")
        out[remat] = _lane_grads(model)
        assert len(calls) == (cfg.num_layers if remat else 0)
    (g0, (l0, _)), (g1, (l1, _)) = out[False], out[True]
    assert torch.equal(l0, l1)
    leaves0, leaves1 = packing.tree_leaves(g0), packing.tree_leaves(g1)
    assert len(leaves0) == len(leaves1)
    assert all(torch.equal(a, b) for a, b in zip(leaves0, leaves1))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_recompute_backwards_keep_no_graph(arch, impl, monkeypatch):
    """``torch.func.grad`` differentiates with ``create_graph=True``; the
    two recompute backwards (remat's, and flash attention's through
    ``sdpa_chunked``) still return gradients that carry no graph. A
    recorded recompute would stay alive until the whole backward ends,
    every block's at once, and remat would lower no peak."""
    from repro_torch.kernels import ops
    seen = []
    for fn in (transformer._Recompute, ops._FlashAttention):
        def backward(ctx, g, real=fn.backward, name=fn.__name__):
            out = real(ctx, g)
            seen.extend((name, t.grad_fn) for t in out
                        if isinstance(t, torch.Tensor))
            return out
        monkeypatch.setattr(fn, "backward", staticmethod(backward))
    for remat in (True, False):
        cfg = dataclasses.replace(configs.get(arch).reduced(), remat=remat)
        _lane_grads(build_model(cfg, ParallelCtx(attn_impl=impl),
                                device="cpu"))
    names = {"_Recompute"} | ({"_FlashAttention"} if impl == "kernel"
                              and arch == "stablelm-1.6b" else set())
    assert {n for n, _ in seen} == names
    assert all(f is None for _, f in seen), seen


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_leaves_no_grad_paths_alone(arch, monkeypatch):
    """Serving and evaluation never enter the recompute Function, and give
    the same bits with remat on as with it off."""
    cfg = configs.get(arch).reduced()
    monkeypatch.setattr(transformer._Recompute, "apply",
                        lambda *a: pytest.fail("remat on a no-grad path"))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)))
    outs = []
    for remat in (True, False):
        model = Model(dataclasses.replace(cfg, remat=remat), device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            logits, _ = model.prefill(params, {"tokens": toks}, max_len=40)
            ev = make_eval_step(model)(params, {"tokens": toks,
                                                "labels": toks})
        outs.append((logits, ev["loss"]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("remat", [True, False])
def test_pool_step_leaves_no_tensor_in_a_reference_cycle(remat):
    """A masked pool step of the LM frees everything it made by reference
    counting: a tensor left in a reference cycle waits for the garbage
    collector, and at a full-width model's size that is gigabytes a step
    (as it was while ``tree_unflatten`` had a recursive closure)."""
    import gc

    from repro_torch.core.lanepool import LanePool
    cfg = dataclasses.replace(configs.get("stablelm-1.6b").reduced(),
                              remat=remat)
    model = build_model(cfg, device="cpu")
    opt = optim.adamw()
    tmpl = model.init(torch.Generator().manual_seed(0))
    pool = LanePool(2, make_train_step(model, opt), template_params=tmpl,
                    template_opt=opt.init(tmpl),
                    template_hparams=torch.tensor(0.0))
    for lane in range(2):
        p = model.init(torch.Generator().manual_seed(lane))
        pool.attach(lane, lane, p, opt.init(p), torch.tensor(1e-3))
    batch = packing.stack_trees([_t(_batch(cfg.vocab_size, s))
                                 for s in range(2)])
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        pool.step(batch)
        gc.collect()
        left = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert left == []


def test_remat_ssm_forward_takes_the_chunked_scan(monkeypatch):
    """Under remat a Mamba2 block's forward runs with grad mode off; it
    still takes the scan autograd takes ("chunked"), so the value and the
    recomputed backward come from one algorithm."""
    from repro_torch.models import ssm
    cfg = dataclasses.replace(configs.get("mamba2-130m").reduced(),
                              remat=True)
    seen = []
    real = ssm._scan
    monkeypatch.setattr(ssm, "_scan",
                        lambda impl, *a: seen.append(impl) or real(impl, *a))
    _lane_grads(build_model(cfg, device="cpu"), n=2)
    assert seen and set(seen) == {"chunked"}


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def _shared_init_model(cfg, jm):
    """The port's Model whose init returns the reference's init at the
    generator's seed, so both packages train from the same values."""
    class Shared(Model):
        def init(self, generator):
            return params_from_numpy(
                _np(jm.init(jax.random.PRNGKey(generator.initial_seed()))),
                self.device)
    return Shared(cfg, device="cpu")


def test_trainer_losses_checkpoint_and_resume_match_reference(tmp_path):
    cfg = configs.get("stablelm-1.6b").reduced()
    jm = jbuild(jconfigs.get("stablelm-1.6b").reduced(), JCtx(moe_oracle=True))
    model = _shared_init_model(cfg, jm)
    data = lambda m: iter(m(vocab_size=cfg.vocab_size, seq_len=16,
                            batch_size=2, seed=0))
    tr = Trainer(model, optim.adamw(weight_decay=0.0),
                 schedule.linear_warmup_cosine(3e-3, 2, 9),
                 checkpoint_dir=str(tmp_path / "port"), checkpoint_every=3,
                 log_every=0)
    jtr = JTrainer(jm, joptim.adamw(weight_decay=0.0),
                   jschedule.linear_warmup_cosine(3e-3, 2, 9),
                   checkpoint_dir=str(tmp_path / "ref"), checkpoint_every=3,
                   log_every=0)
    out = tr.fit(torch.Generator().manual_seed(0), data(SyntheticLM), 7)
    jout = jtr.fit(jax.random.PRNGKey(0), data(JSyntheticLM), 7)
    np.testing.assert_allclose(out["losses"], jout["losses"], **TOL)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "step_0000000003", "step_0000000006", "step_0000000007"]
    # a new fit resumes from step 7 and runs only the remaining steps
    # (its batches restart at the iterator's start, as the reference's).
    # Neither fit ends on a multiple of checkpoint_every: the reference's
    # final save would race its last periodic one (the port's waits, below)
    out2 = tr.fit(torch.Generator().manual_seed(0), data(SyntheticLM), 10)
    jout2 = jtr.fit(jax.random.PRNGKey(0), data(JSyntheticLM), 10)
    assert len(out2["losses"]) == len(jout2["losses"]) == 3
    np.testing.assert_allclose(out2["losses"], jout2["losses"], **TOL)
    assert out2["monitor"]["steps"] == 3


def test_trainer_final_save_waits_for_a_pending_save(tmp_path):
    """The last periodic save (async) and the final save write the same
    step when ``steps`` is a multiple of ``checkpoint_every``: the final
    save waits for the pending one instead of racing it into one tmp
    directory."""
    cfg = configs.get("stablelm-1.6b").reduced()
    tr = Trainer(Model(cfg, device="cpu"), optim.sgd(),
                 schedule.constant(1e-2), checkpoint_dir=str(tmp_path),
                 checkpoint_every=2, log_every=0)
    data = iter(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=8,
                            batch_size=2, seed=0))
    out = tr.fit(torch.Generator().manual_seed(0), data, 4)
    assert len(out["losses"]) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000002", "step_0000000004"]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-130m",
                                  "deepseek-moe-16b", "zamba2-7b",
                                  "qwen2-vl-7b", "seamless-m4t-medium"])
def test_bf16_gradients_bit_equal_by_func_and_autograd(arch, remat):
    """A reduced model's loss gradients in bf16 compute by ``torch.func``
    (the lane pool's route, and ``make_train_step``'s for plain params)
    and by ``torch.autograd`` (``mesh_grads``, a mesh step's route) are
    bit-equal, for a model of each family: SiLU's backward is one kernel
    on both routes (``layers.silu``), where ``torch.func`` differentiated
    ``F.silu`` through bf16 ops (0.006-0.010 of a leaf's largest entry
    apart). The batch is the train cell's, of 2 sequences of 64, drawn
    from a seed (token ids, a vlm's or an encoder's embeddings, M-RoPE
    positions)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.train import mesh_grads
    cfg = dataclasses.replace(configs.get(arch).reduced(),
                              compute_dtype="bfloat16", remat=remat)
    model = Model(cfg, device="cpu",
                  pctx=ParallelCtx(moe_oracle=cfg.family == "moe"))
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(20)
    batch = {}
    for name, spec in model.input_specs(ShapeSpec("t", 64, 2,
                                                  "train")).items():
        if name == "mrope_pos":
            value = np.broadcast_to(np.arange(64), spec.shape)
        elif spec.dtype == torch.int32:
            value = rng.integers(0, cfg.vocab_size, spec.shape)
        else:
            value = rng.standard_normal(spec.shape)
        batch[name] = torch.from_numpy(np.ascontiguousarray(value)).to(
            spec.dtype)
    by_func, _ = torch.func.grad(model.loss, has_aux=True)(params, batch)
    by_autograd, _ = mesh_grads(model.loss, params, batch)
    for a, b in zip(packing.tree_leaves(by_func),
                    packing.tree_leaves(by_autograd)):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)


def test_silu_backward_is_autograds_kernel():
    """``layers.silu``'s value is ``F.silu``'s; its gradient by
    ``torch.func.grad``, by ``torch.autograd`` and under
    ``torch.func.vmap`` is ``aten.silu_backward``'s in bf16 (the kernel
    ``torch.autograd`` runs for ``F.silu``), and in f32 it is what
    ``torch.func`` gave for ``F.silu``."""
    import torch.nn.functional as F
    rng = np.random.default_rng(3)
    x32, g32 = (torch.from_numpy(4 * rng.standard_normal((4, 96)).astype(
        np.float32)) for _ in range(2))
    for x, g in ((x32.bfloat16(), g32.bfloat16()), (x32, g32)):
        want = (torch.ops.aten.silu_backward(g, x) if x.dtype != torch.float32
                else torch.func.grad(lambda x: (F.silu(x) * g).sum())(x))
        assert torch.equal(layers.silu(x), F.silu(x))
        loss = lambda x: (layers.silu(x) * g).float().sum()  # noqa: E731
        assert torch.equal(torch.func.grad(loss)(x), want)
        xr = x.clone().requires_grad_(True)
        assert torch.equal(torch.autograd.grad(loss(xr), xr)[0], want)
        lanes = torch.func.vmap(torch.func.grad(loss))(torch.stack([x, x]))
        assert torch.equal(lanes[0], want) and torch.equal(lanes[1], want)
