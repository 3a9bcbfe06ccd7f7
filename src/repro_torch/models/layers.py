"""Shared building blocks (port of ``repro.models.layers``).

Conventions, as in the reference:
  * params are nested dicts of tensors, stored in ``param_dtype``;
  * forward code casts each weight to the compute dtype at its point of use
    (norm statistics and RoPE stay f32);
  * weight matrices are stored FOLDED, (d_in, d_out): attention projections
    are (d_model, n_heads*head_dim), so ``x @ w`` needs no transpose.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import spans
from repro_torch.distributed.sharding import is_dtensor


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = _row_stat(x, x32.square().mean(dim=-1, keepdim=True))
    out = x32 * _row_stat(x, torch.rsqrt(var + eps))
    return (out * _whole(weight).float()).to(x.dtype)


def _row_stat(x: torch.Tensor, stat: torch.Tensor) -> torch.Tensor:
    """A statistic of each row of ``x`` (B, S, 1), under a mesh where
    ``x``'s last dim is split over "model" held whole on "model" in the
    forward (the row's partial sums added) and in the backward (the
    gradients its rows' shards give it added), so that the norm's
    gradient comes back split as ``x`` is. Left to DTensor, a version may
    place such a sum along the batch over "model" instead, and the
    gradients of the ops around the norm then gather the batch over the
    data axes. Off a mesh, or with ``x``'s last dim whole, ``stat``."""
    if not is_dtensor(x):
        return stat
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import constrain
    mesh = x.device_mesh
    m = mesh.mesh_dim_names.index("model")
    if x.placements[m] != Shard(x.ndim - 1):
        return stat
    whole = list(x.placements)
    whole[m] = Replicate()
    return constrain(stat, mesh, whole)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """f32 statistics; ``var`` is the population variance (``jnp.var``)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * _whole(weight).float() + _whole(bias).float()).to(x.dtype)


def _whole(w: torch.Tensor) -> torch.Tensor:
    """A norm's weight or bias, under a mesh gathered whole on every rank
    at its use (``sharding.fsdp_gather``), so that the activation it
    scales keeps its placements."""
    if is_dtensor(w):
        from repro_torch.distributed.sharding import fsdp_gather
        return fsdp_gather(w, keep_model=False)
    return w


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate split halves. x: (B, S, H, D); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (D/2,)
    ang = positions[..., None].float() * freqs                   # (B, S, D/2)
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# M-RoPE (Qwen2-VL): head_dim split into (t, h, w) sections, each section
# rotated by its own position stream. Section split follows the paper's
# 16/24/24 ratio scaled to head_dim/2.
MROPE_SECTIONS = (2, 3, 3)  # ratios; scaled so sum == head_dim//2


def mrope_section_sizes(head_dim: int) -> tuple:
    half = head_dim // 2
    unit = half // sum(MROPE_SECTIONS)
    sizes = [r * unit for r in MROPE_SECTIONS]
    sizes[-1] += half - sum(sizes)
    return tuple(sizes)


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor,
                theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions_thw: (3, B, S) int (t/h/w streams). The
    first sizes[0] frequencies take their position from t, then h, then
    w."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                       # (D/2,)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(mrope_section_sizes(D), device=x.device),
        output_size=D // 2)                                      # (D/2,)
    pos_per_freq = positions_thw.float()[sec_id]                 # (D/2, B, S)
    ang = pos_per_freq.movedim(0, -1) * freqs                    # (B, S, D/2)
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class _SiLU(torch.autograd.Function):
    """SiLU with one backward on every route: g·σ(x)·(1 + x·(1 − σ(x)))
    computed in f32 from torch ops in that order and rounded once to x's
    dtype, as autograd's ``silu_backward`` kernel does. ``torch.func``
    otherwise differentiates ``F.silu`` through ops of x's dtype, which in
    bf16 round at each step, so a lane pool's gradients and a mesh
    step's differed in their last bits. In f32 the result is the one
    ``torch.func`` gave; and since it is made of torch ops, a step counts
    the same ops on ``meta`` as on a device (``silu_backward`` has no
    ``meta`` kernel: it decomposes there)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return F.silu(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        x = ctx.saved_tensors[0]
        xf = x.float()
        s = torch.sigmoid(xf)
        return (g.float() * s * (1 + xf * (1 - s))).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``F.silu`` with one backward on the ``torch.func`` and the
    ``torch.autograd`` routes (``_SiLU``)."""
    return _SiLU.apply(x)


def at_use(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight at its point of use, cast to the compute ``dtype``. Under
    a mesh a weight that takes a gradient is gathered over the data axes
    first (``sharding.fsdp_gather``), so that its gradient is reduced to
    its shards in the layer's backward; a cast commutes with a gather, so
    the values are the same. One that takes none (serving) is left to
    DTensor's placement, which moves a step's activation rows and not
    the weights. A cast is counted in ``cast_bytes`` (``core.spans``): the
    bytes it reads, under vmap a lane's."""
    if is_dtensor(w) and w.requires_grad:
        from repro_torch.distributed.sharding import fsdp_gather
        w = fsdp_gather(w)
    if w.dtype != dtype:
        spans.count("cast_bytes", w.numel() * w.element_size())
    return w.to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's dtype, ``w`` taken at its use (``at_use``). Under a
    mesh the product is split over "model" along its contraction where
    the weight's placements leave that to DTensor
    (``sharding.split_contraction``), and a decode step's rows meet a
    serving weight split over several data axes in one collective
    (``sharding.rows_product``)."""
    w = at_use(w, x.dtype)
    if is_dtensor(w):
        from repro_torch.distributed.sharding import rows_product
        return rows_product(x, w)
    return x @ w


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str,
             dtype: torch.dtype) -> dict:
    if mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, d_model, d_ff, dtype),
            "w_up": dense_init(gen, d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype),
        }
    return {
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }


def mlp(params: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        g = dense(x, params["w_gate"])
        u = dense(x, params["w_up"])
        h = silu(g) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(x, params["w_up"]), approximate="tanh")
    return dense(h, params["w_down"])


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean token NLL in f32; labels == ignore_id are masked.

    The reference takes the gold logit with a one-hot reduction, which
    keeps a tensor-parallel vocab dim sharded under GSPMD. The port gathers
    it (``torch.take_along_dim``): the same value exactly, without a
    (B, S, V) f32 one-hot as large as the logits themselves. Under a mesh
    (DTensor logits) ``sharded_cross_entropy_loss`` keeps the vocab
    sharded."""
    if is_dtensor(logits):
        return sharded_cross_entropy_loss(logits, labels, ignore_id)
    logits = logits.float()
    mask = (labels != ignore_id).float()
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1.0)


class _LogSumExp(torch.autograd.Function):
    """logsumexp over the last dim of a vocab sharded over ``group``: the
    max and the sum of exponentials are all-reduced. Forward and backward
    are ``torch.logsumexp``'s own formulas, so over one rank the result
    and its gradient are those of ``torch.logsumexp`` bit for bit."""

    @staticmethod
    def forward(x, group):
        import torch.distributed as dist
        m = torch.amax(x, dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        ms = m.squeeze(-1)
        ms = ms.masked_fill(ms.abs() == float("inf"), 0)
        s = torch.exp(x - ms[..., None]).sum(dim=-1)
        dist.all_reduce(s, group=group)
        return s.log() + ms

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * torch.exp(x - out[..., None]), None


def sharded_cross_entropy_loss(logits, labels, ignore_id: int = -1):
    """``cross_entropy_loss`` of DTensor logits (B, S, V) whose vocab is
    over "model" (the head's placements), under ``local_map``: each rank
    takes logsumexp's max and sum over its vocab shard and all-reduces
    them over "model", picks the gold logit where its shard holds the
    label (0 elsewhere) and sums that over "model", and the NLL and the
    label count are summed over the data axes. Over one rank every sum is
    an identity and the value and its gradient are the unsharded
    function's."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.collectives import sum_over_group
    from repro_torch.distributed.sharding import batch_dim, dim_placements
    mesh = logits.device_mesh
    bd = batch_dim(mesh, logits.shape[0])
    model = mesh.get_group("model")
    data = ([mesh.get_group(a) for a in mesh.mesh_dim_names if a != "model"]
            if bd is not None else [])

    def body(lg, lb):
        lg = lg.float()
        V = lg.shape[-1]
        mask = (lb != ignore_id).float()
        label = lb.clamp_min(0).long() - dist.get_rank(model) * V
        mine = (label >= 0) & (label < V)
        gold = torch.take_along_dim(lg, label.clamp(0, V - 1)[..., None],
                                    dim=-1)[..., 0]
        gold = sum_over_group(torch.where(mine, gold, 0.0), model)
        nll = ((_LogSumExp.apply(lg, model) - gold) * mask).sum()
        den = mask.sum()
        for g in data:
            nll, den = sum_over_group(nll, g), sum_over_group(den, g)
        return nll / den.clamp_min(1.0)

    return local_map(body, out_placements=dim_placements(mesh),
                     in_placements=(dim_placements(mesh, data=bd, model=2),
                                    dim_placements(mesh, data=bd)),
                     device_mesh=mesh, redistribute_inputs=True)(
        logits, labels)
