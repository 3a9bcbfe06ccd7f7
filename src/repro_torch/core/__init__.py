"""The paper's primary contribution: triples-mode resource sharing (port of
``repro.core``): placement (``triples``), lanes of one program
(``packing``, ``lanepool``), the LLload-style monitor and gauges
(``monitor``), the packing-factor search (``autotune``), online repacking
(``repack``), fault policies (``faults``), multi-tenant admission
(``tenancy``), the gang scheduler (``scheduler``, ``elastic``,
``spatial``), LLMapReduce (``mapreduce``), the event simulator and its
traces (``simulate``, ``traces``) and the durable control plane
(``eventlog``, ``controlplane``)."""
from repro_torch.core.triples import (  # noqa: F401
    NodeSpec, SlotAssignment, Triples, TriplesPlan, plan)
from repro_torch.core.packing import PackedJobs, packed_step, pack_init  # noqa: F401
from repro_torch.core.autotune import auto_nppn, PackingDecision  # noqa: F401
from repro_torch.core.monitor import RunMonitor, StaticProfile, profile_fn  # noqa: F401
from repro_torch.core.mapreduce import llmapreduce  # noqa: F401
from repro_torch.core.scheduler import (  # noqa: F401
    ClusterState, GangJob, Task, TaskCtx, Tenancy, TriplesScheduler)
from repro_torch.core.tenancy import (  # noqa: F401
    AdmissionDecision, FairShareAccountant, JobQueue, MemoryAdmission,
    PendingJob, TenantQuota)
from repro_torch.core.simulate import (  # noqa: F401
    SimJob, SimReport, compare_modes, comparison_table, mixed_workload)
from repro_torch.core.spatial import (  # noqa: F401
    JobProfile, ModePlanner, NodeModePlan, SliceConfig, SliceSpec,
    ewma_interference, legal_configs)
from repro_torch.core.monitor import TenantGauges  # noqa: F401
from repro_torch.core.faults import (  # noqa: F401
    CrashHook, CrashInjected, FaultPolicy, NodeDown, TaskCrash, TaskOOM,
    TaskWedged, inject_failures, inject_wedge)
from repro_torch.core.eventlog import (  # noqa: F401
    CorruptLogError, EventLog, EventRecord, FencedError, ReplayDivergence,
    decision_view, diff_decision_logs)
from repro_torch.core.controlplane import ControlPlane, register_task  # noqa: F401
