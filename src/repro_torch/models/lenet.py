"""LeNet-4 [LeCun 1998], the paper's MNIST experiment model (port of
``repro.models.lenet``).

4 learned layers: conv(4) -> pool -> conv(16) -> pool -> fc(120) -> fc(10),
trained with the paper's default batch 64. The reference's layouts hold at
the boundary: images NHWC, conv weights HWIO, fc weights (d_in, d_out), and
the flatten before fc(120) runs over (h, w, c) as the reference's does.

The 5x5 "SAME" convolution is written as im2col (``F.unfold``, padding 2)
plus a matmul. Under ``torch.func.vmap`` over lanes, ``F.conv2d``'s weight
gradient of a lane changes in its last bits with the number of lanes beside
it, which would break the pool's bit-identity guarantees (where == compact,
detach/re-attach, rehydrate at another capacity); the im2col form does not.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.model import resolve_device


def _conv(x, w, b):
    """x (B, C, H, W); w HWIO (5, 5, C, O) -> (B, O, H, W)."""
    B, C, H, W = x.shape
    kh, kw, _, O = w.shape
    cols = F.unfold(x, (kh, kw), padding=(kh // 2, kw // 2))  # (B, C*kh*kw, HW)
    wm = w.permute(3, 2, 0, 1).reshape(O, C * kh * kw)
    return (wm @ cols).reshape(B, O, H, W) + b.reshape(O, 1, 1)


def _pool(x):
    return F.max_pool2d(x, 2, 2)


def init(generator: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
    """Random params drawn from ``generator`` on ``device``: ``cuda`` unless
    another device is given, raising when no card is present and the caller
    asked for none. ``generator`` must live on that device
    (``torch.Generator(device=...).manual_seed(s)``)."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params on "
                         f"{device}")

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=device)

    def dense(d_in, d_out):
        return normal(d_in, d_out) * (1.0 / math.sqrt(d_in))

    zeros = lambda n: torch.zeros((n,), device=device)
    return {
        "c1_w": normal(5, 5, 1, 4) * 0.1, "c1_b": zeros(4),
        "c2_w": normal(5, 5, 4, 16) * 0.1, "c2_b": zeros(16),
        "f1_w": dense(7 * 7 * 16, 120), "f1_b": zeros(120),
        "f2_w": dense(120, 10), "f2_b": zeros(10),
    }


def apply(params, image) -> torch.Tensor:
    x = image.permute(0, 3, 1, 2)                      # NHWC -> NCHW
    x = _pool(torch.tanh(_conv(x, params["c1_w"], params["c1_b"])))
    x = _pool(torch.tanh(_conv(x, params["c2_w"], params["c2_b"])))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten as NHWC
    x = torch.tanh(x @ params["f1_w"] + params["f1_b"])
    return x @ params["f2_w"] + params["f2_b"]


def loss(params, batch) -> torch.Tensor:
    logits = apply(params, batch["image"])
    classes = torch.arange(10, device=logits.device)
    onehot = (batch["label"][..., None] == classes).to(logits.dtype)
    return -torch.mean(torch.sum(F.log_softmax(logits, -1) * onehot, -1))
