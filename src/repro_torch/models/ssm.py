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
    a = torch.exp(dt_t.to(_F32) * A.to(_F32))             # (B,nh)
    xb = x_t.to(_F32) * dt_t.to(_F32)[..., None]          # (B,nh,hd)
    upd = xb[..., None] * B_t.to(_F32)[:, None, None, :]
    new_state = state * a[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C_t.to(_F32))
    return y.to(x_t.dtype), new_state


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
    """conv_state (B,width-1,Ch) holds previous inputs; x_t (B,Ch)."""
    full = torch.cat([conv_state, x_t[:, None]], dim=1)   # (B,width,Ch)
    y = torch.einsum("bwc,wc->bc", full, w) + b
    return y, full[:, 1:]


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

    from repro_torch.distributed.sharding import (axis_sizes, constrain,
                                                  dim_placements)
    mesh = x.device_mesh
    nh = x.shape[2]
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


def _project_on_mesh(params: dict, x, d_in: int, nh: int, s: SSMConfig):
    """The in-projection and the causal conv of ``_block`` on a mesh whose
    "model" axis has more than one rank: z, the conv's outputs x, B and C
    (after SiLU), dt before its bias, and the decode conv state (the
    projected conv input's last width-1 rows). One product for each column
    block of w_in (z, x, B, C, dt) at its use: w_in gathered whole over
    "model" (and over the data axes where it takes a gradient:
    ``layers.at_use``), each block then split over "model" along its
    columns where "model" divides its width, and its product split along
    the contraction where not (``sharding.split_contraction``); the conv
    likewise on each of x, B and C. So every output keeps its own split
    over "model" and its weight gradient is computed on it: one product
    split over "model" would be cut into z, xBC and dt off its shard
    edges, for which DTensor gathers the whole (B, S, d_in + ch + nh)
    product (and some versions compute its weight gradient whole on every
    rank). x comes back split over "model" along whole heads, or whole."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import (constrain, model_dim,
                                                  split_contraction)
    mesh = x.device_mesh
    m = mesh.mesh_dim_names.index("model")

    def on_model(t, p):
        out = list(t.placements)
        out[m] = p
        return out

    def whole(t):
        return constrain(t, mesh, on_model(t, Replicate()), t.placements)

    N, tail = s.state_dim, s.conv_width - 1
    w = whole(layers.at_use(params["w_in"], x.dtype))
    conv_w, conv_b = (whole(params[k].to(x.dtype))
                      for k in ("conv_w", "conv_b"))
    outs, lo = [], 0
    for n in (d_in, d_in, N, N, nh):             # z, x, B, C, dt
        blk = w[:, lo:lo + n]
        if model_dim(mesh, n, 1) is not None:
            blk = constrain(blk, mesh, on_model(blk, Shard(1)),
                            blk.placements)
        out = split_contraction(x, blk)
        # its gradient held to its placements, so that the weight
        # gradient is taken on the split whatever DTensor would pick
        outs.append(constrain(out, mesh, out.placements))
        lo += n
    z, x_in, b_in, c_in, dt_raw = outs
    convs, lo = [], 0
    for t in (x_in, b_in, c_in):
        n = t.shape[-1]
        convs.append(layers.silu(causal_conv1d(t, conv_w[:, lo:lo + n],
                                               conv_b[lo:lo + n])))
        lo += n
    xs = convs[0]
    xs = constrain(xs, mesh, on_model(
        xs, Replicate() if model_dim(mesh, nh, 0) is None else Shard(2)))
    state = torch.cat([t[:, -tail:] for t in (x_in, b_in, c_in)], -1)
    return z, xs, convs[1], convs[2], dt_raw, state


def _block(params: dict, x, d_model: int, s: SSMConfig, init_state,
           impl: Optional[str]):
    """``mamba2_block`` that also returns the decode conv state: the last
    width-1 rows of the projected conv input xBC (B, S, ch)."""
    d_in, nh, ch = dims(d_model, s)
    if is_dtensor(x) and x.device_mesh.shape[
            x.device_mesh.mesh_dim_names.index("model")] > 1:
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
    y = y.reshape(b, S, d_in)
    if is_dtensor(y):
        # the gated norm and the out-projection on d_in split over "model"
        # (where the scan gave the heads back whole and "model" divides
        # d_in), and the gradient held to the merged heads' placements
        # before the view's backward splits it into heads (a dim sharded
        # along part-heads cannot split)
        from torch.distributed.tensor import Shard

        from repro_torch.distributed.sharding import constrain, model_dim
        mesh = y.device_mesh
        split = list(y.placements)
        m = mesh.mesh_dim_names.index("model")
        if mesh.shape[m] > 1 and model_dim(mesh, d_in, 2) is not None:
            split[m] = Shard(2)
        y = constrain(y, mesh, split, y.placements)
    y = layers.rms_norm(y * layers.silu(z), params["norm_w"])
    return layers.dense(y, params["w_out"]), state, conv_state


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
    """One-token decode. x_t (B,d). state={'conv':(B,w-1,ch),'ssm':(B,nh,hd,N)}."""
    z, xBC, dt_raw, (d_in, nh, ch) = _project(params, x_t, d_model, s)
    xBC, conv_state = causal_conv1d_step(
        state["conv"], xBC, params["conv_w"].to(x_t.dtype),
        params["conv_b"].to(x_t.dtype))
    xBC = layers.silu(xBC)
    xs = xBC[..., :d_in]
    Bm = xBC[..., d_in:d_in + s.state_dim]
    Cm = xBC[..., d_in + s.state_dim:]
    xh = xs.reshape(-1, nh, s.head_dim)
    dt = F.softplus(dt_raw.to(_F32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, ssm_state = ssd_decode_step(state["ssm"], xh, dt, A, Bm, Cm)
    y = y + params["D"].to(x_t.dtype)[None, :, None] * xh
    y = y.reshape(-1, d_in)
    y = layers.rms_norm(y * layers.silu(z), params["norm_w"])
    return y @ params["w_out"].to(x_t.dtype), {"conv": conv_state,
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
