"""The roofline of a step, counted by running it (port of
``repro.roofline``): ``analysis`` holds the report, the hardware presets
and the ``IntensityProfile`` the scheduler records; ``counting`` counts a
step's FLOPs and bytes."""
from repro_torch.roofline.analysis import (  # noqa: F401
    HW, IntensityProfile, RooflineReport, analyze_step, attn_kernel_io_bytes,
    model_flops)
