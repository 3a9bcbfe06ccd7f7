"""Plain reference of the dense decoder the port runs for StableLM-2: token
embedding; per layer x + attention(rmsnorm(x)) then x + SwiGLU(rmsnorm(x))
with rotary positions over the whole head; a final RMSNorm and an untied
head; the mean token cross-entropy. Training follows AdamW as the port's
``optim.adamw`` documents it (moments in f32, global-norm clipping of the
gradient first, decoupled weight decay, bias-corrected moments)."""
from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.common import padded_vocab
from perfbench.reference import common as C


def layout(port: dict) -> list:
    """(path, shape, init) of every parameter, in the port's tree: matrices
    stored (d_in, d_out), layers stacked on a leading axis. ``init``:
    "dense:<fan_in>" N(0, 1/fan_in), "embed" N(0, 0.02²), "ones"."""
    d, L, ff = port["d_model"], port["num_layers"], port["d_ff"]
    H = port["num_heads"]
    D = port.get("head_dim") or d // H
    V = padded_vocab(port)
    return [
        (("embed",), (V, d), "embed"),
        (("final_ln",), (d,), "ones"),
        (("unembed",), (d, V), f"dense:{d}"),
        (("blocks", "ln1"), (L, d), "ones"),
        (("blocks", "attn", "w_q"), (L, d, H * D), f"dense:{d}"),
        (("blocks", "attn", "w_k"), (L, d, H * D), f"dense:{d}"),
        (("blocks", "attn", "w_v"), (L, d, H * D), f"dense:{d}"),
        (("blocks", "attn", "w_o"), (L, H * D, d), f"dense:{H * D}"),
        (("blocks", "ln2"), (L, d), "ones"),
        (("blocks", "mlp", "w_gate"), (L, d, ff), f"dense:{d}"),
        (("blocks", "mlp", "w_up"), (L, d, ff), f"dense:{d}"),
        (("blocks", "mlp", "w_down"), (L, ff, d), f"dense:{ff}"),
    ]


def forward(params, tokens, port: dict, precision: str = "f32"):
    """Logits (B, S, V) f32 of tokens (B, S)."""
    d, H = port["d_model"], port["num_heads"]
    D = port.get("head_dim") or d // H
    eps, theta = port.get("norm_eps", 1e-5), port.get("rope_theta", 1e4)
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    h = params["embed"][tokens.long()].float()
    blocks = params["blocks"]
    for i in range(port["num_layers"]):
        p = C.index(blocks, i)
        h = h + C.attention(p["attn"], C.rms_norm(h, p["ln1"], eps), pos, H,
                            D, theta, precision)
        h = h + C.swiglu(p["mlp"], C.rms_norm(h, p["ln2"], eps), precision)
    h = C.rms_norm(h, params["final_ln"], eps)
    return C.matmul(h, params["unembed"], precision)


def serve_logits(params, seq, port: dict, precision: str, keep_from: int):
    """Logits of one served sequence (S,) at positions keep_from on."""
    return forward(params, seq[None], port, precision)[0, keep_from:]


def loss(params, batch, port: dict, precision: str = "f32"):
    logits = forward(params, batch["tokens"], port, precision)
    return C.cross_entropy(logits, batch["labels"])


def leaf_names(tree, prefix=()) -> List[tuple]:
    """Paths of the leaves in the port's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                           prefix + (k,))]
    return [prefix]


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def train(params0: Dict, batches: list, lr: float, port: dict,
          opt: dict, precision: str = "f32") -> dict:
    """``len(batches)`` AdamW steps from ``params0`` (left unchanged).
    Returns each step's loss, the per-leaf norm of the first step's
    gradient as the optimizer takes it (after clipping), and the per-leaf
    norm of the parameters' change after the last step, leaves named by
    their dotted paths."""
    names = leaf_names(params0)
    p = [get(params0, n).detach().float().clone().requires_grad_(True)
         for n in names]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    wd, clip = opt["weight_decay"], opt["grad_clip"]
    losses, grad_norms = [], None

    def tree_of(leaves):
        out: dict = {}
        for n, t in zip(names, leaves):
            node = out
            for k in n[:-1]:
                node = node.setdefault(k, {})
            node[n[-1]] = t
        return out

    for step, batch in enumerate(batches, start=1):
        value = loss(tree_of(p), batch, port, precision)
        grads = torch.autograd.grad(value, p)
        losses.append(float(value.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = (torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0)
                     if clip else torch.ones(()))
            grads = [g * scale for g in grads]
            if grad_norms is None:
                grad_norms = torch.stack([g.norm() for g in grads]).tolist()
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for t, g, mi, vi in zip(p, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mi / c1) / (torch.sqrt(vi / c2) + eps) + wd * t
                t.sub_(lr * upd)
        del grads
    with torch.no_grad():
        deltas = torch.stack([(t - get(params0, n).float()).norm()
                              for t, n in zip(p, names)]).tolist()
    return {"names": [".".join(n) for n in names], "losses": losses,
            "grad_norms": grad_norms, "delta_norms": deltas}
