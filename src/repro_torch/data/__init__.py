"""Synthetic datasets and the LM data pipeline (numpy only; copied from
``repro.data``)."""
from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLM, TokenFileDataset, write_token_file, make_lm_batch)
from repro_torch.data.mnist import synthetic_mnist, synthetic_imagenet  # noqa: F401
