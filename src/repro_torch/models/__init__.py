"""Model building blocks and the dense/ssm ``Model`` (port of
``repro.models``)."""
from repro_torch.models.model import Model, build_model  # noqa: F401
from repro_torch.models.transformer import ParallelCtx  # noqa: F401
