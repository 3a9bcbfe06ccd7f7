"""Entry points: the continuous-batching ``BatchServer`` (port of
``repro.launch.serve``)."""
