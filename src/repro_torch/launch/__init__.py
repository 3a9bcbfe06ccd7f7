"""Entry points (port of ``repro.launch``): the continuous-batching
``BatchServer`` (``serve``), the training step and ``Trainer`` (``train``),
and the parametric sweep ``run_sweep`` (``sweep``)."""
