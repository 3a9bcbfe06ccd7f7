"""Entry points (port of ``repro.launch``): the continuous-batching
``BatchServer`` (``serve``), the training step and ``Trainer`` (``train``),
the parametric sweep ``run_sweep`` (``sweep``), the production meshes
(``mesh``) and the multi-pod dry-run (``dryrun``, run as ``python -m
repro_torch.launch.dryrun``). Importing the package imports none of
them."""
