"""The paper's mechanism: triples-mode placement (``triples``), lanes of one
program (``packing``), the lane pool with continuous refill (``lanepool``),
the LLload-style monitor and gauges (``monitor``), the packing-factor search
(``autotune``), online repacking (``repack``), fault policies (``faults``)
and multi-tenant admission (``tenancy``). Port of ``repro.core``; the
scheduler, simulator and durability layer are not ported yet."""
from repro_torch.core.triples import (  # noqa: F401
    NodeSpec, SlotAssignment, Triples, TriplesPlan, plan)
from repro_torch.core.packing import PackedJobs, packed_step, pack_init  # noqa: F401
from repro_torch.core.autotune import auto_nppn, PackingDecision  # noqa: F401
from repro_torch.core.monitor import (  # noqa: F401
    RunMonitor, StaticProfile, TenantGauges, profile_fn)
from repro_torch.core.tenancy import (  # noqa: F401
    AdmissionDecision, FairShareAccountant, JobQueue, MemoryAdmission,
    PendingJob, TenantQuota)
from repro_torch.core.faults import (  # noqa: F401
    CrashHook, CrashInjected, FaultPolicy, NodeDown, TaskCrash, TaskOOM,
    TaskWedged, inject_failures, inject_wedge)
