"""Synthetic stand-ins for the paper's experiment datasets.

No network access in this container, so MNIST/ImageNet are generated
class-conditional Gaussian-blob images with deterministic seeds — the
throughput/memory behaviour (what the paper measures) is shape-identical;
the paper does not report accuracy.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def synthetic_mnist(batch: int, step: int, seed: int = 0,
                    ) -> Dict[str, np.ndarray]:
    """(B, 28, 28, 1) float32 images in [0,1] + labels (B,) int32."""
    rng = np.random.Generator(np.random.Philox(key=seed,
                                               counter=[step, 0, 0, 0]))
    labels = rng.integers(0, 10, size=(batch,))
    base = rng.standard_normal((batch, 28, 28, 1)).astype(np.float32) * 0.1
    # class-dependent blob so the model can learn
    xx, yy = np.meshgrid(np.arange(28), np.arange(28))
    for i, c in enumerate(labels):
        cx, cy = 4 + (c % 5) * 5, 4 + (c // 5) * 12
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 18.0))
        base[i, :, :, 0] += blob.astype(np.float32)
    return {"image": np.clip(base, 0, 1), "label": labels.astype(np.int32)}


def synthetic_imagenet(batch: int, step: int, seed: int = 0, res: int = 64,
                       classes: int = 1000) -> Dict[str, np.ndarray]:
    """Reduced-resolution ImageNet-shaped batch (B, res, res, 3)."""
    rng = np.random.Generator(np.random.Philox(key=seed,
                                               counter=[step, 1, 0, 0]))
    labels = rng.integers(0, classes, size=(batch,))
    imgs = rng.standard_normal((batch, res, res, 3)).astype(np.float32) * 0.2
    freq = (labels % 7 + 1).astype(np.float32)
    t = np.linspace(0, np.pi, res, dtype=np.float32)
    wave = np.sin(np.outer(freq, t))[:, None, :, None]
    imgs = imgs + wave
    return {"image": imgs, "label": labels.astype(np.int32)}
