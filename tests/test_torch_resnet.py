"""The port's ResNet-18 (``models/resnet.py``, the paper's §III-B model) and
the tree helpers it needs (params with lists: ``params["blocks"]`` is a
list of stages, each a list of blocks) against the JAX reference, f32 on
the CPU from the reference's own parameters, at width 0.25, batch 2 and
16 px (even: each stride-2 3x3 conv pads 0 above/left and 1 below/right,
XLA's SAME) and 17 px (odd: 1 on both sides).

Tolerances: the forward's logits and the loss within 1e-5 (f32 convs and
GroupNorm sums in other orders; the readings are below 1e-6); gradients
within 1e-4 of the largest entry of each leaf, as
``tests/test_torch_moe.py``; a 2-lane ``packed_step`` within 1e-5 of each
lane stepped alone and of the reference's ``jax.vmap`` step. Not bits:
under ``torch.func.vmap`` a convolution's weight gradient depends on the
lane count (ROADMAP C4), and the reference asserts no bit-identity across
lane counts for this ladder."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from chip_smoke import resnet_step
from repro import optim as joptim
from repro.core import packing as jpacking
from repro.models import resnet as jresnet
from repro_torch import optim
from repro_torch.core import packing
from repro_torch.data import synthetic_imagenet
from repro_torch.models import resnet
from repro_torch.models.convert import params_from_numpy

WIDTH, CLASSES, BATCH = 0.25, 10, 2
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.fixture(scope="module")
def ref():
    jp = jresnet.init(jax.random.PRNGKey(0), width=WIDTH, classes=CLASSES)
    return jp, params_from_numpy(_np(jp), "cpu")


def _batch(res, seed=0, step=0):
    return synthetic_imagenet(BATCH, step, seed=seed, res=res,
                              classes=CLASSES)


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("width,classes", [(0.25, 10), (1.0, 1000)])
def test_init_tree_matches_reference(width, classes):
    """Keys, list nesting, shapes and dtypes against ``jax.eval_shape`` of
    the reference's init (width 1.0: 11.7 M params, drawn under
    FakeTensorMode)."""
    want = jax.eval_shape(lambda k: jresnet.init(k, width, classes),
                          jax.random.PRNGKey(0))
    with FakeTensorMode():
        mine = resnet.init(torch.Generator().manual_seed(0), width, classes,
                           device="cpu")
    assert _shapes(mine) == _shapes(want)
    assert [len(stage) for stage in mine["blocks"]] == [2, 2, 2, 2]
    assert ["proj" in b for stage in mine["blocks"] for b in stage] == \
        [False, False, True, False, True, False, True, False]


def test_tree_helpers_take_lists_in_pytree_order(ref):
    """``params_from_numpy`` keeps the lists; ``tree_leaves`` gives the
    leaves in ``jax.tree_util.tree_leaves`` order (dict keys sorted, list
    items in order), ``tree_unflatten`` inverts it, and ``stack_trees`` /
    ``unstack_tree`` (and ``tree_set_lane``) round-trip exactly."""
    jp, tp = ref
    assert isinstance(tp["blocks"], list) and isinstance(tp["blocks"][0],
                                                         list)
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jp)]
    got = packing.tree_leaves(tp)
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(got, want))
    back = packing.tree_unflatten(tp, [t.clone() for t in got])
    assert _shapes(back) == _shapes(tp)
    other = packing.tree_map(lambda t: t + 1, tp)
    stacked = packing.stack_trees([tp, other])
    assert stacked["blocks"][1][0]["w1"].shape[0] == 2
    for lane, orig in zip(packing.unstack_tree(stacked, 2), (tp, other)):
        assert all(torch.equal(a, b) for a, b in zip(
            packing.tree_leaves(lane), packing.tree_leaves(orig)))
    packing.tree_set_lane(stacked, 0, other)
    assert all(torch.equal(a, b) for a, b in zip(
        packing.tree_leaves(packing.lane_slice(stacked, 0)),
        packing.tree_leaves(other)))


@pytest.mark.parametrize("size,stride,want", [(16, 2, (0, 1)), (17, 2, (1, 1)),
                                              (16, 1, (1, 1)), (7, 2, (1, 1))])
def test_same_padding_is_xlas(size, stride, want):
    """A 3x3 SAME conv's (low, high) padding, and the conv itself against
    ``jax.lax.conv_general_dilated(padding="SAME")``."""
    assert resnet._same_pads(size, 3, stride) == want
    x = np.random.default_rng(size).standard_normal(
        (1, size, size, 4)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((3, 3, 4, 5)).astype(
        np.float32)
    got = resnet._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w), stride).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jresnet._conv(
        jnp.asarray(x), jnp.asarray(w), stride)), **TOL)


@pytest.mark.parametrize("res", [16, 17])
def test_apply_loss_and_gradient_match_reference(ref, res):
    jp, tp = ref
    b = _batch(res, seed=res)
    np.testing.assert_allclose(
        resnet.apply(tp, torch.from_numpy(b["image"])).numpy(),
        np.asarray(jax.jit(jresnet.apply)(jp, jnp.asarray(b["image"]))),
        **TOL)
    jl, jg = jax.jit(jax.value_and_grad(jresnet.loss))(jp, _j(b))
    g, tl = torch.func.grad_and_value(resnet.loss)(tp, _t(b))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for mine, want in zip(packing.tree_leaves(g),
                          jax.tree_util.tree_leaves(_np(jg))):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(mine.numpy() - want).max()) <= GRAD_REL * scale


def test_packed_step_two_lanes_matches_each_lane_alone_and_reference():
    """``packing.packed_step`` over 2 lanes (the ladder's NPPN 2, SGD), two
    steps: each lane within 1e-5 of the same lane stepped alone, and of the
    reference's ``jax.vmap`` step."""
    jps = [jresnet.init(jax.random.PRNGKey(i), width=WIDTH, classes=CLASSES)
           for i in range(2)]
    jopt, opt = joptim.sgd(), optim.sgd()

    def jstep(params, opt_state, batch, lr):
        l, g = jax.value_and_grad(jresnet.loss)(params, batch)
        upd, opt_state = jopt.update(g, opt_state, params, lr)
        return joptim.apply_updates(params, upd), opt_state, {"loss": l}

    step = resnet_step(opt)
    lanes = [params_from_numpy(_np(p), "cpu") for p in jps]
    alone = [(p, opt.init(p)) for p in lanes]
    params = packing.stack_trees(lanes)
    opt_state = packing.stack_trees([opt.init(p) for p in lanes])
    jparams = jpacking.stack_trees(jps)
    jstate = jax.vmap(jopt.init)(jparams)
    jpacked = jpacking.packed_step(jstep, donate=False)
    packed = packing.packed_step(step)
    lr = 0.1
    for s in range(2):
        batches = [_batch(16, seed=i, step=s) for i in range(2)]
        params, opt_state, m = packed(
            params, opt_state, packing.stack_trees([_t(b) for b in batches]),
            torch.full((2,), lr))
        jparams, jstate, jm = jpacked(
            jparams, jstate, jpacking.stack_trees([_j(b) for b in batches]),
            jnp.full((2,), lr, jnp.float32))
        for i, b in enumerate(batches):
            p, o, mi = step(*alone[i], _t(b), torch.tensor(lr))
            alone[i] = (p, o)
            np.testing.assert_allclose(float(m["loss"][i]), float(mi["loss"]),
                                       **TOL)
            np.testing.assert_allclose(float(m["loss"][i]),
                                       float(jm["loss"][i]), **TOL)
    for i in range(2):
        for got, one, want in zip(
                packing.tree_leaves(packing.lane_slice(params, i)),
                packing.tree_leaves(alone[i][0]),
                jax.tree_util.tree_leaves(jpacking.tree_get_lane(
                    jparams, i))):
            np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
