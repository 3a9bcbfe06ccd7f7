"""Mamba2 / SSD (state-space duality) sequence mixer [arXiv:2405.21060].

Port of ``repro.models.ssm``. ``ssd_chunked`` is the chunked SSD algorithm in
plain PyTorch, f32 inside: within a chunk the recurrence runs in its dual
(attention-like) matrix form, and the small recurrent state (B, nh, hd, N)
is carried across chunks by a Python loop (the reference's ``lax.scan``).
Decode runs the recurrent step directly.

Which scan a full-sequence block uses is ``impl``, as for attention
(``attention.default_impl``): ``"kernel"`` is ``kernels.ops.ssd`` (the
Hopper kernel on a CUDA tensor, its plain version on a CPU tensor; the
default on ``cuda``), ``"chunked"`` is ``ssd_chunked`` (the reference's own
path; the default on ``cpu``), ``"plain"`` is the kernel's plain version
``kernels.ssd_scan.ssd_scan_plain`` on any device. With no ``impl`` given,
``scan_impl`` picks: "chunked" whenever autograd needs the scan's result
(the kernel has no backward; the reference's model always runs
``ssd_chunked``, in training too), else the device's default, so the
kernel serves every no-grad prefill on the card. Each of them starts from
a block's ``init_state`` when it is given (the TPU kernel always starts from
zero; the port's kernel takes the state as an input).

Conventions: x (B,S,nh,hd); dt (B,S,nh); A (nh,) negative reals;
B/C (B,S,N) shared across heads (ngroups=1, as in mamba2-130m).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models import layers
from repro_torch.models.attention import default_impl

_F32 = torch.float32


# ---------------------------------------------------------------------------
# core SSD scan (plain PyTorch, f32 internals)
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, B, C, *, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,nh,hd) in x.dtype, final_state (B,nh,hd,N) f32)."""
    b, S, nh, hd = x.shape
    N = B.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} % chunk {chunk} != 0")
    nc = S // chunk

    xc = x.to(_F32).reshape(b, nc, chunk, nh, hd)
    dtc = dt.to(_F32).reshape(b, nc, chunk, nh)
    Bc = B.to(_F32).reshape(b, nc, chunk, N)
    Cc = C.to(_F32).reshape(b, nc, chunk, N)

    # per-step log decay  la_t = dt_t * A  (A < 0)
    dA = dtc * A.to(_F32)                                 # (b,nc,Q,nh)
    la = torch.cumsum(dA, dim=2)                          # inclusive cumsum
    la_total = la[:, :, -1]                               # (b,nc,nh)

    xb = xc * dtc[..., None]                              # dt-weighted inputs

    # ---- intra-chunk (dual / attention-like form) ----
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)          # (b,nc,Q,Q)
    # decay[i,j,h] = exp(la_i - la_j) for i >= j else 0. The mask goes in
    # before the exp (-inf for i < j), not after it: for i < j the exp may
    # be inf, and the gradient of a where after it is then 0 * inf = NaN
    # (the reference masks after the exp, and its gradient is NaN once a
    # chunk's decays pass exp's range: Zamba2's 128-step chunks at
    # training). The same values either way
    diff = la[:, :, :, None, :] - la[:, :, None, :, :]    # (b,nc,Q,Q,nh)
    iq = torch.arange(chunk, device=x.device)
    tri = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    decay = torch.exp(diff.masked_fill(~tri, float("-inf")))
    y_intra = torch.einsum("bcij,bcijh,bcjhp->bcihp", CB, decay, xb)

    # ---- chunk-boundary states ----
    # state contribution of chunk c: sum_j exp(la_Q - la_j) * xb_j ⊗ B_j
    decay_out = torch.exp(la_total[:, :, None, :] - la)   # (b,nc,Q,nh)
    chunk_state = torch.einsum("bcjh,bcjhp,bcjn->bchpn", decay_out, xb, Bc)

    state = (torch.zeros((b, nh, hd, N), dtype=_F32, device=x.device)
             if init_state is None else init_state.to(_F32))
    states_in = []                                        # state BEFORE chunk
    for c in range(nc):
        states_in.append(state)
        state = state * torch.exp(la_total[:, c])[:, :, None, None] \
            + chunk_state[:, c]
    states_in = torch.stack(states_in, dim=1)             # (b,nc,nh,hd,N)

    # ---- inter-chunk: y_i += exp(la_i) * C_i . state_in ----
    c_decayed = Cc[:, :, :, None, :] * torch.exp(la)[..., None]  # (b,nc,Q,nh,N)
    y_inter = torch.einsum("bcihn,bchpn->bcihp", c_decayed, states_in)

    y = (y_intra + y_inter).reshape(b, S, nh, hd)
    return y.to(x.dtype), state


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. state (B,nh,hd,N); x_t (B,nh,hd); dt_t (B,nh);
    B_t/C_t (B,N). Returns (y_t (B,nh,hd), new_state)."""
    new_state = _state_update(state, x_t, dt_t, A, B_t)
    return _read_out(new_state, C_t, x_t.dtype), new_state


def _state_update(state, x_t, dt_t, A, B_t):
    """The decayed state plus this step's input: (B,nh,hd,N) f32."""
    a = torch.exp(dt_t.to(_F32) * A.to(_F32))             # (B,nh)
    xb = x_t.to(_F32) * dt_t.to(_F32)[..., None]          # (B,nh,hd)
    upd = xb[..., None] * B_t.to(_F32)[:, None, None, :]
    return state * a[:, :, None, None] + upd


def _read_out(state, C_t, dtype):
    """y_t (B,nh,hd) in ``dtype``: each head's state read by C_t."""
    return torch.einsum("bhpn,bn->bhp", state, C_t.to(_F32)).to(dtype)


# ---------------------------------------------------------------------------
# depthwise causal conv1d (width <= 4 unrolled shifts)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, b):
    """x (B,S,Ch); w (width,Ch); b (Ch,). Causal depthwise conv. Under a
    mesh it runs under ``local_map``, the batch over the data axes and the
    channels over "model" where they divide (a channel's conv reads its
    own channel only)."""
    if is_dtensor(x):
        return _conv_on_mesh(x, w, b)
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    S = x.shape[1]
    out = sum(pad[:, i:i + S] * w[i] for i in range(width))
    return out + b


def _conv_on_mesh(x, w, b):
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import (batch_dim, dim_placements,
                                                  model_dim)
    mesh = x.device_mesh
    bd, ch = batch_dim(mesh, x.shape[0]), model_dim(mesh, x.shape[2], 0)
    x_p = dim_placements(mesh, data=bd, model=None if ch is None else 2)
    w_p = dim_placements(mesh, model=None if ch is None else 1)
    b_p = dim_placements(mesh, model=ch)
    partial = bd is not None   # each rank's rows add their weight gradient
    return local_map(
        causal_conv1d, out_placements=x_p, in_placements=(x_p, w_p, b_p),
        in_grad_placements=(
            x_p, dim_placements(mesh, model=None if ch is None else 1,
                                data_partial=partial),
            dim_placements(mesh, model=ch, data_partial=partial)),
        device_mesh=mesh, redistribute_inputs=True)(x, w, b)


def causal_conv1d_step(conv_state, x_t, w, b):
    """conv_state (B,width-1,Ch) holds previous inputs; x_t (B,Ch). Under a
    mesh it runs under ``local_map`` in the conv state's placements (the
    cache's), x_t moved to them, w and b whole: each rank steps its own
    rows (DTensor's own einsum cannot view a batch dim that is marked
    split, even over one rank)."""
    if is_dtensor(conv_state):
        return _conv_step_on_mesh(conv_state, x_t, w, b)
    full = torch.cat([conv_state, x_t[:, None]], dim=1)   # (B,width,Ch)
    y = torch.einsum("bwc,wc->bc", full, w) + b
    return y, full[:, 1:]


def _conv_step_on_mesh(conv_state, x_t, w, b):
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import dim_placements
    mesh = conv_state.device_mesh
    st_p = list(conv_state.placements)
    # x_t (B, Ch) split as the state (B, width-1, Ch) is: its dim 1 is gone
    x_p = [Shard(p.dim - (p.dim > 0)) if p.is_shard() else p for p in st_p]
    whole = dim_placements(mesh)
    return local_map(
        causal_conv1d_step, out_placements=(x_p, st_p),
        in_placements=(st_p, x_p, whole, whole), device_mesh=mesh,
        redistribute_inputs=True)(conv_state, x_t, w, b)


# ---------------------------------------------------------------------------
# full Mamba2 block
# ---------------------------------------------------------------------------

def dims(d_model: int, s: SSMConfig):
    d_in = s.expand * d_model
    nh = s.num_heads or d_in // s.head_dim
    ch = d_in + 2 * s.state_dim      # conv channels: x_ssm + B + C
    return d_in, nh, ch


def init_mamba2(gen: torch.Generator, d_model: int, s: SSMConfig,
                dtype) -> dict:
    d_in, nh, ch = dims(d_model, s)
    dev = gen.device
    # in_proj emits [z(d_in), xBC(ch), dt(nh)]
    d_proj = d_in + ch + nh
    w_in = layers.dense_init(gen, d_model, d_proj, dtype)
    conv_w = (torch.randn((s.conv_width, ch), generator=gen, device=dev,
                          dtype=_F32) / math.sqrt(s.conv_width)).to(dtype)
    u = torch.rand((nh,), generator=gen, device=dev, dtype=_F32)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    a = 1.0 + 15.0 * torch.rand((nh,), generator=gen, device=dev, dtype=_F32)
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((ch,), dtype=dtype, device=dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),     # inv softplus, f32
        "A_log": torch.log(a),
        "D": torch.ones((nh,), dtype=_F32, device=dev),
        "norm_w": torch.ones((d_in,), dtype=dtype, device=dev),
        "w_out": layers.dense_init(gen, d_in, d_model, dtype),
    }


def _project(params, x, d_model, s: SSMConfig):
    d_in, nh, ch = dims(d_model, s)
    proj = layers.dense(x, params["w_in"])
    z = proj[..., :d_in]
    xBC = proj[..., d_in:d_in + ch]
    dt_raw = proj[..., d_in + ch:]
    return z, xBC, dt_raw, (d_in, nh, ch)


def needs_grad(*tensors) -> bool:
    """Whether autograd (or ``torch.func.grad``) would need a result
    computed from ``tensors``: grad mode is on and one of them requires
    grad. ``None`` entries are skipped."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def scan_impl(device, grad: bool) -> str:
    """The scan a block runs when no ``impl`` is given: "chunked" when
    autograd needs its result, else ``attention.default_impl(device)``
    ("kernel" on ``cuda``). A pure function of (device, needs-grad)."""
    return "chunked" if grad else default_impl(device)


def _scan(impl: str, x, dt, A, B, C, chunk: int, init_state):
    if is_dtensor(x):                     # under a mesh: on local shards
        return _scan_on_mesh(lambda x, dt, A, B, C, s: _scan(
            impl, x, dt, A, B, C, chunk, s), x, dt, A, B, C, init_state)
    if impl == "chunked":
        return ssd_chunked(x, dt, A, B, C, chunk=chunk, init_state=init_state)
    if impl == "kernel":
        from repro_torch.kernels import ops
        return ops.ssd(x, dt, A, B, C, chunk=chunk, init_state=init_state)
    if impl == "plain":
        from repro_torch.kernels.ssd_scan import ssd_scan_plain
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                              init_state=init_state)
    raise ValueError(f"unknown SSD impl {impl!r}")


def _scan_on_mesh(fn, x, dt, A, B, C, init_state=None):
    """``fn(x, dt, A, B, C, init_state)`` (a scan: y and the final state)
    on DTensor operands under ``local_map``: the batch over the data axes
    and the heads over "model" where they divide, B and C (shared by the
    heads) replicated over "model"; each rank's scan (the kernel, on the
    card) gets its plain local tensors. The gradients of A (over the data
    axes, when the batch is split) and of B and C (over "model", when the
    heads are) are partial sums."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import (axis_sizes, batch_dim,
                                                  dim_placements, model_dim)
    mesh = x.device_mesh
    b, nh = x.shape[0], x.shape[2]
    bd, hd = batch_dim(mesh, b), model_dim(mesh, nh, 2)
    if hd is None and axis_sizes(mesh)["model"] > 1:
        return _scan_split_heads(fn, x, dt, A, B, C, init_state, bd)
    on = lambda mdl: dim_placements(mesh, data=bd, model=mdl)  # noqa: E731
    heads = hd is not None
    x_p, bc_p, st_p = on(hd), on(None), on(1 if heads else None)
    a_p = dim_placements(mesh, model=0 if heads else None)
    a_g = dim_placements(mesh, model=0 if heads else None,
                         data_partial=bd is not None)
    bc_g = dim_placements(mesh, data=bd, model_partial=heads)
    st = None if init_state is None else st_p
    return local_map(
        fn, out_placements=(x_p, st_p),
        in_placements=(x_p, x_p, a_p, bc_p, bc_p, st),
        in_grad_placements=(x_p, x_p, a_g, bc_g, bc_g, st),
        device_mesh=mesh, redistribute_inputs=True)(x, dt, A, B, C,
                                                    init_state)


def _scan_split_heads(fn, x, dt, A, B, C, init_state, bd):
    """``_scan_on_mesh`` where "model" does not divide the heads: each
    "model" rank takes the operands whole over "model" and scans its own
    ceil(nh / model) heads (the last ranks' made up with heads of zero
    input and zero step, whose outputs are dropped), so that a rank scans
    a share of the heads and not all of them. y and the final state come
    back gathered over "model" to the heads that exist; the operands'
    gradients are partial sums over "model" (each rank's covers its own
    heads)."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import constrain, dim_placements
    mesh = x.device_mesh
    nh = x.shape[2]
    mine = _head_share(mesh, nh)

    def scan(x, dt, A, B, C, s):
        return fn(mine(x, 2), mine(dt, 2), mine(A, 0), B, C,
                  None if s is None else mine(s, 1))

    whole = dim_placements(mesh, data=bd)
    grad = dim_placements(mesh, data=bd, model_partial=True)
    a_g = dim_placements(mesh, data_partial=bd is not None,
                         model_partial=True)
    y_p, st_p = (dim_placements(mesh, data=bd, model=d) for d in (2, 1))
    st = None if init_state is None else whole
    y, state = local_map(
        scan, out_placements=(y_p, st_p),
        in_placements=(whole, whole, dim_placements(mesh), whole, whole, st),
        in_grad_placements=(grad, grad, a_g, grad, grad,
                            None if st is None else grad),
        device_mesh=mesh, redistribute_inputs=True)(x, dt, A, B, C,
                                                    init_state)
    return (constrain(y, mesh, whole, y_p)[:, :, :nh],
            constrain(state, mesh, whole, st_p)[:, :nh])


def _head_share(mesh, nh: int):
    """``mine(t, dim)``: this "model" rank's share of ``nh`` heads along
    ``dim`` of ``t``, ceil(nh / model) of them, the last ranks' made up
    with zero heads (a rank past the heads takes zeros only)."""
    from repro_torch.distributed.sharding import axis_sizes
    per = -(-nh // axis_sizes(mesh)["model"])
    lo = min(mesh.get_local_rank("model") * per, nh)
    n = min(per, nh - lo)

    def mine(t, dim):
        part = t.narrow(dim, lo, n)
        if n == per:
            return part
        shape = list(part.shape)
        shape[dim] = per - n
        return torch.cat([part, part.new_zeros(shape)], dim)
    return mine


def _project_on_mesh(params: dict, x, d_in: int, nh: int, s: SSMConfig):
    """The in-projection and the causal conv of ``_block`` on a mesh whose
    "model" axis has more than one rank: z, the conv's outputs x, B and C
    (after SiLU), dt before its bias, and the decode conv state (the
    projected conv input's last width-1 rows). The products are
    ``_in_blocks``'; the conv runs on each of x, B and C on its own split.
    x comes back split over "model" along whole heads, or whole."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import constrain, model_dim
    mesh = x.device_mesh
    z, x_in, b_in, c_in, dt_raw = _in_blocks(params, x, d_in, nh, s)
    conv_w, conv_b = _conv_params(params, x)
    convs, lo = [], 0
    for t in (x_in, b_in, c_in):
        n = t.shape[-1]
        convs.append(layers.silu(causal_conv1d(t, conv_w[:, lo:lo + n],
                                               conv_b[lo:lo + n])))
        lo += n
    xs = convs[0]
    xs = constrain(xs, mesh, _on_model(
        xs, Replicate() if model_dim(mesh, nh, 0) is None else Shard(2)))
    tail = s.conv_width - 1
    state = torch.cat([t[:, -tail:] for t in (x_in, b_in, c_in)], -1)
    return z, xs, convs[1], convs[2], dt_raw, state


def _on_model(t, p) -> list:
    """``t``'s placements with p on "model"."""
    out = list(t.placements)
    out[t.device_mesh.mesh_dim_names.index("model")] = p
    return out


def _whole_on_model(t):
    """``t`` (a DTensor) whole over "model", its gradient going back to
    its own placements."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import constrain
    return constrain(t, t.device_mesh, _on_model(t, Replicate()),
                     t.placements)


def _conv_params(params: dict, x):
    """The conv's weight and bias in x's dtype, whole over "model"."""
    return (_whole_on_model(params[k].to(x.dtype))
            for k in ("conv_w", "conv_b"))


def _in_blocks(params: dict, x, d_in: int, nh: int, s: SSMConfig):
    """z, x, B, C and dt (before its bias) of a Mamba2 block's input x
    (B, S, d) or (B, d), DTensors on a mesh whose "model" axis has more
    than one rank: one product for each column block of w_in at its use.
    w_in is gathered whole over "model" (and over the data axes where it
    takes a gradient: ``layers.at_use``); each block is then split over
    "model" along its columns where "model" divides its width, and its
    product split along the contraction where not
    (``sharding.split_contraction``). So every output keeps its own split
    over "model" and its weight gradient is computed on it: one product
    split over "model" would be cut into z, xBC and dt off its shard
    edges, for which DTensor gathers the whole (B, S, d_in + ch + nh)
    product (and some versions compute its weight gradient whole on every
    rank). Each output is held to x's batch rows over the data axes where
    they divide them: a decode step's rows, gathered to meet a serving
    weight split over the data axes along the contraction
    (``sharding.rows_product``), go back to the rows as partial sums
    reduce-scattered, not summed whole on every rank."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import (batch_dim, constrain,
                                                  model_dim, rows_product)
    mesh = x.device_mesh
    rows = batch_dim(mesh, x.shape[0]) is not None
    w = _whole_on_model(layers.at_use(params["w_in"], x.dtype))
    outs, lo = [], 0
    for n in (d_in, d_in, s.state_dim, s.state_dim, nh):   # z, x, B, C, dt
        blk = w[:, lo:lo + n]
        if model_dim(mesh, n, 1) is not None:
            blk = constrain(blk, mesh, _on_model(blk, Shard(1)),
                            blk.placements)
        out = rows_product(x, blk)
        # the rows over the data axes (whole where they do not divide
        # them: partial sums summed), and the gradient held to the same
        # placements, so that the weight gradient is taken on the split
        # whatever DTensor would pick
        place = [p if a == "model" else Shard(0) if rows
                 else Replicate() if p.is_partial() else p
                 for a, p in zip(mesh.mesh_dim_names, out.placements)]
        outs.append(constrain(out, mesh, place))
        lo += n
    return outs


def _state_step_on_mesh(state, x, dt, A, B, C):
    """``ssd_decode_step`` on DTensor operands under ``local_map``: the
    batch over the data axes, and the state (B, nh, hd, N) in the
    placements the cache holds it in (``sharding.batch_specs``), which
    are prefill's. Where "model" divides the heads each rank steps its own
    heads, the state split over "model" along them. Where it does not, the
    state is whole over "model" on every rank: each rank decays and adds
    to every head (no product), and reads out y for its own share of
    ceil(nh / model) heads (``_head_share``, the last ranks' made up with
    zero heads, dropped), which is gathered over "model" (a few KB a
    layer). No rank gathers the state."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import (batch_dim, constrain,
                                                  dim_placements, model_dim)
    mesh = x.device_mesh
    b, nh = x.shape[0], x.shape[1]
    bd = batch_dim(mesh, b)
    on = lambda mdl: dim_placements(mesh, data=bd, model=mdl)  # noqa: E731
    if model_dim(mesh, nh, 1) is not None:
        heads, bc_p = on(1), on(None)
        return local_map(
            ssd_decode_step, out_placements=(heads, heads),
            in_placements=(heads, heads, heads, dim_placements(mesh, model=0),
                           bc_p, bc_p),
            device_mesh=mesh, redistribute_inputs=True)(state, x, dt, A, B,
                                                        C)
    mine = _head_share(mesh, nh)

    def step(state, x, dt, A, B, C):
        new = _state_update(state, x, dt, A, B)
        return _read_out(mine(new, 1), C, x.dtype), new

    whole, y_p = on(None), on(1)
    y, new = local_map(
        step, out_placements=(y_p, whole),
        in_placements=(whole, whole, whole, dim_placements(mesh), whole,
                       whole),
        device_mesh=mesh, redistribute_inputs=True)(state, x, dt, A, B, C)
    return constrain(y, mesh, whole)[:, :nh], new


def _block(params: dict, x, d_model: int, s: SSMConfig, init_state,
           impl: Optional[str]):
    """``mamba2_block`` that also returns the decode conv state: the last
    width-1 rows of the projected conv input xBC (B, S, ch)."""
    d_in, nh, ch = dims(d_model, s)
    if _on_mesh(x):
        z, xs, Bm, Cm, dt_raw, conv_state = _project_on_mesh(
            params, x, d_in, nh, s)
    else:
        z, xBC_in, dt_raw, _ = _project(params, x, d_model, s)
        xBC = layers.silu(causal_conv1d(xBC_in,
                                        params["conv_w"].to(x.dtype),
                                        params["conv_b"].to(x.dtype)))
        xs = xBC[..., :d_in]
        Bm = xBC[..., d_in:d_in + s.state_dim]
        Cm = xBC[..., d_in + s.state_dim:]
        conv_state = xBC_in[:, -(s.conv_width - 1):]
    b, S, _ = x.shape
    xh = xs.reshape(b, S, nh, s.head_dim)    # a view: the kernel reads xBC
    dt = F.softplus(dt_raw.to(_F32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    impl = impl or scan_impl(x.device,
                             needs_grad(xh, dt, A, Bm, Cm, init_state))
    y, state = _scan(impl, xh, dt, A, Bm, Cm, s.chunk_size, init_state)
    y = y + params["D"].to(x.dtype)[None, None, :, None] * xh
    return _gate_out(params, y.reshape(b, S, d_in), z), state, conv_state


def _on_mesh(x) -> bool:
    """Whether x is a DTensor on a mesh whose "model" axis has more than
    one rank (where a block takes its mesh routes)."""
    return is_dtensor(x) and x.device_mesh.shape[
        x.device_mesh.mesh_dim_names.index("model")] > 1


def _gate_out(params: dict, y, z):
    """The gated norm and the out-projection of y (..., d_in). Under a
    mesh they run on d_in split over "model" (where the scan or the
    decode step gave the heads back whole and "model" divides d_in), and
    the gradient is held to the merged heads' placements before the
    view's backward splits it into heads (a dim sharded along part-heads
    cannot split)."""
    if is_dtensor(y):
        from torch.distributed.tensor import Shard

        from repro_torch.distributed.sharding import constrain, model_dim
        mesh = y.device_mesh
        split = list(y.placements)
        m = mesh.mesh_dim_names.index("model")
        if mesh.shape[m] > 1 and model_dim(mesh, y.shape[-1], 0) is not None:
            split[m] = Shard(y.ndim - 1)
        y = constrain(y, mesh, split, y.placements)
    y = layers.rms_norm(y * layers.silu(z), params["norm_w"])
    return layers.dense(y, params["w_out"])


def mamba2_block(params: dict, x, d_model: int, s: SSMConfig,
                 init_state: Optional[torch.Tensor] = None,
                 impl: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2. x (B,S,d). Returns (y, final_ssm_state)."""
    y, state, _ = _block(params, x, d_model, s, init_state, impl)
    return y, state


def mamba2_prefill(params: dict, x, d_model: int, s: SSMConfig,
                   impl: Optional[str] = None) -> Tuple[torch.Tensor, dict]:
    """Full-sequence Mamba2 that also returns the decode state
    {'conv': last width-1 projected inputs, 'ssm': final state}, from one
    projection (the reference projects a second time for the conv state)."""
    y, state, conv = _block(params, x, d_model, s, None, impl)
    return y, {"conv": conv, "ssm": state}


def mamba2_decode_step(params: dict, x_t, state: dict, d_model: int,
                       s: SSMConfig) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x_t (B,d). state={'conv':(B,w-1,ch),'ssm':(B,nh,hd,N)}.

    On DTensors the state update runs under ``local_map``
    (``_state_step_on_mesh``), and the new state keeps the placements of
    the one given, which are the cache's. Where "model" has more than one
    rank the in-projection is one product per column block of w_in
    (``_in_blocks``), the batch rows kept over the data axes; the conv
    step takes x, B and C gathered whole over "model" (one row each), so
    that the conv state keeps its cache placements too (whole over
    "model", as prefill leaves it), and its output goes back to the
    rows of its input (a hybrid's cache holds its conv state with the
    batch over "model": ``sharding.batch_specs``' rule for a path that
    names "ssm")."""
    d_in, nh, ch = dims(d_model, s)
    on_mesh = _on_mesh(x_t)
    if on_mesh:
        z, x_in, b_in, c_in, dt_raw = _in_blocks(params, x_t, d_in, nh, s)
        xBC = torch.cat([_whole_on_model(t) for t in (x_in, b_in, c_in)], -1)
        conv_w, conv_b = _conv_params(params, x_t)
    else:
        z, xBC, dt_raw, _ = _project(params, x_t, d_model, s)
        conv_w, conv_b = (params[k].to(x_t.dtype) for k in ("conv_w",
                                                            "conv_b"))
    rows = xBC.placements if on_mesh else None
    xBC, conv_state = causal_conv1d_step(state["conv"], xBC, conv_w, conv_b)
    if on_mesh:
        from repro_torch.distributed.sharding import constrain
        xBC = constrain(xBC, xBC.device_mesh, rows)
    xBC = layers.silu(xBC)
    xs = xBC[..., :d_in]
    Bm = xBC[..., d_in:d_in + s.state_dim]
    Cm = xBC[..., d_in + s.state_dim:]
    xh = xs.reshape(-1, nh, s.head_dim)
    dt = F.softplus(dt_raw.to(_F32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    step = _state_step_on_mesh if is_dtensor(xh) else ssd_decode_step
    y, ssm_state = step(state["ssm"], xh, dt, A, Bm, Cm)
    y = y + params["D"].to(x_t.dtype)[None, :, None] * xh
    return _gate_out(params, y.reshape(-1, d_in), z), {"conv": conv_state,
                                                       "ssm": ssm_state}


def init_decode_state(batch: int, d_model: int, s: SSMConfig, dtype,
                      device=None) -> dict:
    d_in, nh, ch = dims(d_model, s)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, s.head_dim, s.state_dim), dtype=_F32,
                           device=device),
    }


def ssd_reference_recurrent(x, dt, A, B, C):
    """O(S) sequential oracle for tests: literal recurrence, no chunking."""
    b, S, nh, hd = x.shape
    state = torch.zeros((b, nh, hd, B.shape[-1]), dtype=_F32, device=x.device)
    ys = []
    for t in range(S):
        y, state = ssd_decode_step(state, x[:, t], dt[:, t], A, B[:, t],
                                   C[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state
