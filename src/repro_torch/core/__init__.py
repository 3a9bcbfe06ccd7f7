"""The paper's mechanism: triples-mode placement (``triples``), lanes of one
program (``packing``), the lane pool with continuous refill (``lanepool``)
and the LLload-style monitor (``monitor``). Port of ``repro.core``; the
policy layer (scheduler, tenancy, repack, ...) is not ported yet."""
from repro_torch.core.triples import (  # noqa: F401
    NodeSpec, SlotAssignment, Triples, TriplesPlan, plan)
from repro_torch.core.packing import PackedJobs, packed_step, pack_init  # noqa: F401
from repro_torch.core.monitor import RunMonitor, StaticProfile, profile_fn  # noqa: F401
