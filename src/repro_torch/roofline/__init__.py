"""The roofline of a step, counted by running it (port of
``repro.roofline``): ``analysis`` holds the report, the hardware presets,
the ``IntensityProfile`` the scheduler records and the collectives'
``CollectiveOp``; ``counting`` counts a step's FLOPs, bytes and
collectives."""
from repro_torch.roofline.analysis import (  # noqa: F401
    HW, CollectiveOp, IntensityProfile, RooflineReport, analyze_step,
    attn_kernel_io_bytes, model_flops, parse_collectives)
