"""ResNet-18 [He et al. 2016], the paper's ImageNet experiment model (§III-B)
(port of ``repro.models.resnet``), with the reference's ``width`` knob.

BatchNorm is replaced by GroupNorm (batch-size independent, so lanes packed
under ``torch.func.vmap`` never mix statistics), as in the reference. The
reference's layouts hold at the boundary: images NHWC, conv weights HWIO,
the head (d_in, classes); params are {"stem_w", "stem_g", "stem_b",
"blocks": [stage][block] dicts, "head_w", "head_b"}, f32. Inside, the
activations are NCHW for ``F.conv2d`` (the reference leaves its
convolutions to XLA, outside any Pallas kernel).

Two details of the reference that change the numbers:
  * ``padding="SAME"`` pads as XLA does: total = max((out - 1)·s + k - in,
    0), low = total // 2, so a 3x3 stride-2 conv on an even input pads 0
    above and left and 1 below and right (``F.conv2d(padding=1)`` would pad
    1 on both sides);
  * GroupNorm's variance is the population variance (``jnp.var``; not
    ``torch.var``'s default), over min(8, C) groups.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.model import resolve_device

STAGES = [(64, 1), (128, 2), (256, 2), (512, 2)]   # (channels, first stride)


def _same_pads(size: int, k: int, stride: int) -> tuple:
    """XLA's SAME padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """x (B, C, H, W); w HWIO (k, k, C, O) -> (B, O, H', W'), SAME."""
    k = w.shape[0]
    (ht, hb), (wl, wr) = (_same_pads(x.shape[2], k, stride),
                          _same_pads(x.shape[3], k, stride))
    if (ht, wl) != (hb, wr):
        x = F.pad(x, (wl, wr, ht, hb))
        ht = wl = 0
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride,
                    padding=(ht, wl))


def _gn(x, scale, bias, groups: int = 8):
    """The reference's ``_gn``: channel c in group c // (C / g), population
    variance, eps 1e-5; ``F.group_norm`` computes exactly that, in one
    kernel instead of the reference's six passes."""
    return F.group_norm(x, min(groups, x.shape[1]), scale, bias, 1e-5)


def _block_init(normal, cin: int, cout: int, stride: int, zeros, ones):
    scale = (2.0 / (9 * cin)) ** 0.5
    p = {"w1": normal(3, 3, cin, cout) * scale,
         "g1": ones(cout), "b1": zeros(cout),
         "w2": normal(3, 3, cout, cout) * scale,
         "g2": ones(cout), "b2": zeros(cout)}
    if stride != 1 or cin != cout:
        p["proj"] = normal(1, 1, cin, cout) * scale
    return p


def _block_apply(p, x, stride: int):
    h = F.relu(_gn(_conv(x, p["w1"], stride), p["g1"], p["b1"]))
    h = _gn(_conv(h, p["w2"]), p["g2"], p["b2"])
    if "proj" in p:
        x = _conv(x, p["proj"], stride)
    return F.relu(x + h)


def init(generator: torch.Generator, width: float = 1.0,
         classes: int = 1000, device=None) -> Dict:
    """Random params drawn from ``generator`` on ``device``: ``cuda`` unless
    another device is given, raising when no card is present and the caller
    asked for none. ``generator`` must live on that device."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params on "
                         f"{device}")

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=device)

    zeros = lambda n: torch.zeros((n,), device=device)
    ones = lambda n: torch.ones((n,), device=device)
    w0 = int(64 * width)
    params = {"stem_w": normal(3, 3, 3, w0) * 0.1,
              "stem_g": ones(w0), "stem_b": zeros(w0), "blocks": []}
    cin = w0
    for ch, stride in STAGES:
        cout = int(ch * width)
        stage = []
        for b in range(2):                     # ResNet-18: 2 blocks/stage
            stage.append(_block_init(normal, cin, cout,
                                     stride if b == 0 else 1, zeros, ones))
            cin = cout
        params["blocks"].append(stage)
    params["head_w"] = normal(cin, classes) * 0.02
    params["head_b"] = zeros(classes)
    return params


def apply(params, image) -> torch.Tensor:
    """image (B, H, W, 3) NHWC -> logits (B, classes)."""
    x = image.permute(0, 3, 1, 2)                      # NHWC -> NCHW
    x = F.relu(_gn(_conv(x, params["stem_w"]), params["stem_g"],
                   params["stem_b"]))
    for stage, (ch, stride) in zip(params["blocks"], STAGES):
        for b, p in enumerate(stage):
            x = _block_apply(p, x, stride if b == 0 else 1)
    x = x.mean(dim=(2, 3))
    return x @ params["head_w"] + params["head_b"]


def loss(params, batch) -> torch.Tensor:
    logits = apply(params, batch["image"])
    classes = logits.shape[-1]
    target = batch["label"] % classes
    onehot = (target[..., None] == torch.arange(
        classes, device=logits.device)).to(logits.dtype)
    return -torch.mean(torch.sum(F.log_softmax(logits, -1) * onehot, -1))
