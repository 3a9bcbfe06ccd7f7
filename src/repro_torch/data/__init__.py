"""Synthetic datasets (numpy only; copied from ``repro.data.mnist``)."""
from repro_torch.data.mnist import synthetic_mnist, synthetic_imagenet  # noqa: F401
