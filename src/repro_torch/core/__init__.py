"""Lane packing helpers used by serving (port of ``repro.core.packing``)."""
