"""Online tape-serving subsystem: public API.

Callers should import from here rather than the submodules: the event loop
and admission policies (:mod:`.queue`), the shared drive pool with pluggable
mount scheduling (:mod:`.drives`), the discrete-event simulator oracle and
report types (:mod:`.sim`), the QoS layer (:mod:`.qos`), and the opt-in
fault-injection / crash-recovery layer (:mod:`.faults`).

Everything here simulates *one* robotic library; :mod:`repro_torch.fleet`
federates N of these servers behind one arrival stream.

**Observability.**  The serving loop is instrumented end to end through
the opt-in :mod:`repro_torch.obs` bundle: attach one via
``ExecutionContext(obs=Observability.enabled())`` and the event loop,
drive pool, and cache emit virtual-time spans (queue waits, mounts,
batches — one trace track per drive) plus exact-int counters and
histograms that reconcile with :class:`~repro_torch.serving.sim.ServiceReport`
/ :func:`~repro_torch.serving.qos.slo_report` integers with ``==``, never
approximately.  With ``obs`` unset (the default) every hook is a no-op
on a shared null bundle and the serving path is pinned bit-identical to
the uninstrumented stack — same timelines, same journal bytes.  Export
the collected data with :mod:`repro_torch.obs.export` (byte-deterministic
JSONL span logs, Prometheus text, Chrome ``trace_event`` JSON).

The serving loop solves through the context's backend: ``"cuda"`` builds
every cold dispatch's tables with the hand-written kernels, ``"torch"`` with
their plain version (on ``device="cpu"`` without a card), ``"python"``
with the exact host DP; all three serve identical timelines.
"""

from .drives import (
    FAIL_STOP,
    MOUNT_SCHEDULERS,
    DriveCosts,
    DrivePool,
    GreedyScheduler,
    LookaheadScheduler,
    LRUScheduler,
    MountScheduler,
    MountView,
    NoDriveAvailableError,
    PoolDrive,
    RetryPolicy,
    resolve_scheduler,
)
from .faults import (
    DriveFailure,
    EventJournal,
    FaultInjector,
    FaultPlan,
    JournalReplayError,
    MediaFault,
    MediaReadError,
    MountFailedError,
    MountFault,
    ShardOutage,
    SolverFault,
    recover_server,
    seeded_fault_plan,
)
from .qos import DEFAULT_CLASS, ClassSLO, QoSSpec, SLOReport, int_quantile, slo_report
from .queue import (
    ADMISSIONS,
    LEGACY_ADMISSIONS,
    POOL_ADMISSIONS,
    QOS_ADMISSIONS,
    WINDOWED_ADMISSIONS,
    OnlineTapeServer,
    serve_trace,
)
from .sim import (
    BatchRecord,
    FailedRequest,
    Leg,
    Replay,
    Request,
    ServedRequest,
    ServiceReport,
    demo_library,
    head_position,
    poisson_trace,
    replay_schedule,
    rewind_time,
)

__all__ = [
    # queue / admissions
    "OnlineTapeServer",
    "serve_trace",
    "ADMISSIONS",
    "LEGACY_ADMISSIONS",
    "POOL_ADMISSIONS",
    "QOS_ADMISSIONS",
    "WINDOWED_ADMISSIONS",
    # drive pool + mount scheduling
    "DrivePool",
    "DriveCosts",
    "PoolDrive",
    "MountScheduler",
    "MountView",
    "MOUNT_SCHEDULERS",
    "GreedyScheduler",
    "LRUScheduler",
    "LookaheadScheduler",
    "resolve_scheduler",
    # QoS layer
    "QoSSpec",
    "SLOReport",
    "ClassSLO",
    "slo_report",
    "int_quantile",
    "DEFAULT_CLASS",
    # simulator + reports
    "Request",
    "ServedRequest",
    "BatchRecord",
    "ServiceReport",
    "Replay",
    "Leg",
    "replay_schedule",
    "head_position",
    "rewind_time",
    "poisson_trace",
    "demo_library",
    # fault injection / retries / crash recovery
    "FaultPlan",
    "FaultInjector",
    "DriveFailure",
    "ShardOutage",
    "MountFault",
    "MediaFault",
    "SolverFault",
    "seeded_fault_plan",
    "RetryPolicy",
    "FAIL_STOP",
    "EventJournal",
    "recover_server",
    "JournalReplayError",
    "MountFailedError",
    "MediaReadError",
    "NoDriveAvailableError",
    "FailedRequest",
]
