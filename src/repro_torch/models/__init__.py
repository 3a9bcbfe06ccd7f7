"""Model building blocks and the dense ``Model`` (port of ``repro.models``)."""
