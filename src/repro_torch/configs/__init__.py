from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    SHAPES_BY_NAME,
    LONG_CONTEXT_ARCHS,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeSpec,
    available,
    cell_is_runnable,
    get,
    register,
)
