"""One reader per per-layer metric, named as the metric: ``read(ctx)``
returns the metric's value from the traced run's context (the driver's
statistics under "train" or "serve", the device trace's summary under
"trace"), or None when the run holds nothing to read."""
