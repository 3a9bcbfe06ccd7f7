"""LLMapReduce on the port against the reference on the CPU: the three
cases of ``tests/test_integration.py`` (packed against slotted, empty
items, no padding waste), the pool's device, and a parametric study over
the reduced StableLM-2 whose packed lanes reach B3 through ``ops`` under
the pool's ``vmap`` (its plain version here), held to the reference's
``llmapreduce`` over the same parameters."""
import functools
import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import triples as JT
from repro.core.mapreduce import llmapreduce as jllmapreduce
from repro.models import ParallelCtx as JCtx, build_model as jbuild
from repro_torch import configs
from repro_torch.core import triples as T
from repro_torch.core.mapreduce import llmapreduce
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import ParallelCtx, build_model
from repro_torch.models.convert import params_from_numpy

# f32 on both sides, the same algorithm summed in other orders (the
# package-parity bound of the port's training tests)
TOL = dict(rtol=2e-5, atol=2e-5)


def _items(n=9):
    return [torch.tensor(float(i)) for i in range(n)]


def test_llmapreduce_packed_vs_slotted():
    items = _items()
    f = lambda x: x * x
    packed = llmapreduce(f, items, trip=T.Triples(1, 4, 1), mode="packed",
                         device="cpu")
    slotted = llmapreduce(lambda x: float(x) ** 2, items,
                          trip=T.Triples(2, 2, 1), mode="slotted")
    np.testing.assert_allclose([float(p) for p in packed],
                               [float(s) for s in slotted])
    total = llmapreduce(f, items, trip=T.Triples(1, 4, 1),
                        reduce_fn=lambda a, b: a + b, device="cpu")
    assert float(total) == sum(i * i for i in range(9))
    want = jllmapreduce(f, [jnp.float32(i) for i in range(9)],
                        trip=JT.Triples(1, 4, 1), mode="packed")
    assert [float(p) for p in packed] == [float(w) for w in want]


def test_llmapreduce_empty_items():
    assert llmapreduce(lambda x: x * x, [], mode="packed") == []
    assert llmapreduce(lambda x: x * x, [], mode="slotted") == []
    with pytest.raises(ValueError, match="empty items"):
        llmapreduce(lambda x: x * x, [], reduce_fn=lambda a, b: a + b)
    out, stats = llmapreduce(lambda x: x, [], return_stats=True)
    assert out == [] and stats.lane_steps == 0


def test_llmapreduce_packed_no_padding_waste():
    """9 items over 4 slots: 9 active lane-steps in 3 pool steps, one
    step program."""
    out, stats = llmapreduce(lambda x: x * x, _items(),
                             trip=T.Triples(1, 4, 1), mode="packed",
                             return_stats=True, device="cpu")
    np.testing.assert_allclose([float(v) for v in out],
                               [i * i for i in range(9)])
    assert stats.lane_steps == 9
    assert stats.global_steps == 3
    assert stats.n_traces == 1


def test_packed_pool_lives_on_the_named_device():
    """The device the caller names; results on it."""
    out = llmapreduce(lambda x: x + 1, _items(3), device="cpu")
    assert all(o.device.type == "cpu" for o in out)
    # the slotted path runs map_fn as it is, on no pool
    assert llmapreduce(lambda x: x + 1, [1, 2], mode="slotted") == [2, 3]


def test_packed_pool_defaults_to_the_items_device():
    """Unnamed, the pool takes the first item's device (the first tensor
    of its tree); items that hold no tensor default to ``cuda``, which
    raises without a card."""
    items = [{"a": 2.0, "x": torch.tensor([float(i)])} for i in range(3)]
    out = llmapreduce(lambda b: b["x"] * b["a"], items)
    assert [o.device.type for o in out] == ["cpu"] * 3
    np.testing.assert_allclose([o.item() for o in out], [0.0, 2.0, 4.0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            llmapreduce(lambda x: x + 1, [1, 2])


N_ITEMS, SEQ = 5, 16


@pytest.fixture(scope="module")
def study():
    """The reduced StableLM-2 in both packages from one set of reference
    parameters, and N_ITEMS prompts drawn from a numpy seed."""
    cfg = jconfigs.get("stablelm-1.6b").reduced()
    jm = jbuild(cfg, JCtx(moe_oracle=True))
    np_params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (N_ITEMS, 1, SEQ + 1),
                        dtype=np.int32)
    items = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    return cfg, jm, np_params, items


def test_parametric_study_packed_through_b3_matches_reference(
        study, monkeypatch):
    """Packed scoring of N_ITEMS prompts over a 2-slot pool, attention on
    the "kernel" path: ops -> B3's wrapper (its plain version on the CPU)
    once per layer per pool step, the lane axis folded into B. Losses
    within the f32 bound of the reference's llmapreduce, and equal to the
    port's own slotted run at batch 1 within the same bound."""
    cfg, jm, np_params, items = study
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    want = jllmapreduce(lambda b: jm.loss(jparams, b)[0],
                        [{k: jnp.asarray(v) for k, v in it.items()}
                         for it in items],
                        trip=JT.Triples(1, 2, 1), mode="packed")

    model = build_model(configs.get("stablelm-1.6b").reduced(),
                        ParallelCtx(attn_impl="kernel"), device="cpu")
    params = params_from_numpy(np_params, "cpu")

    def score(batch):
        with torch.no_grad():
            return model.loss(params, batch)[0]

    calls = []
    real = fa.flash_attention_fwd

    def counted(q, *a, **kw):
        calls.append(tuple(q.shape))
        return real(q, *a, **kw)
    monkeypatch.setattr(fa, "flash_attention_fwd", counted)
    titems = [{k: torch.from_numpy(v) for k, v in it.items()}
              for it in items]
    got, stats = llmapreduce(score, titems, trip=T.Triples(1, 2, 1),
                             mode="packed", return_stats=True, device="cpu")
    assert stats.lane_steps == N_ITEMS and stats.global_steps == 3
    assert stats.n_traces == 1
    assert calls == [(2, SEQ, cfg.num_heads, cfg.resolved_head_dim)] * (
        3 * cfg.num_layers)
    np.testing.assert_allclose([float(g) for g in got],
                               [float(w) for w in want], **TOL)

    calls.clear()
    slotted = llmapreduce(lambda b: float(score(b)), titems,
                          trip=T.Triples(1, 2, 1), mode="slotted")
    assert len(calls) == N_ITEMS * cfg.num_layers
    np.testing.assert_allclose(slotted, [float(g) for g in got], **TOL)
    total = llmapreduce(lambda b: float(score(b)), titems,
                        trip=T.Triples(1, 2, 1), mode="slotted",
                        reduce_fn=lambda a, b: a + b)
    assert total == functools.reduce(operator.add, slotted)
