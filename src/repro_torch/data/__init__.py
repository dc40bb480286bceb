"""Dataset substrate: synthetic IN2P3-like tape workloads + adversarial families."""

from .generator import (
    BENCH_PROFILE,
    DatasetProfile,
    PAPER_PROFILE,
    SMALL_PROFILE,
    generate_instance,
    generate_dataset,
    u_turn_values,
)
from .paper_instances import (
    gs_worst_case,
    simpledp_worst_case,
    logdp_worst_case,
)
from .traces import (
    DEFAULT_QOS_CLASSES,
    TRACE_SCHEMA,
    TraceRecord,
    qos_poisson_trace,
    read_trace,
    records_of,
    to_requests,
    write_trace,
)

__all__ = [
    "DatasetProfile",
    "PAPER_PROFILE",
    "SMALL_PROFILE",
    "BENCH_PROFILE",
    "generate_instance",
    "generate_dataset",
    "u_turn_values",
    "gs_worst_case",
    "simpledp_worst_case",
    "logdp_worst_case",
    "TRACE_SCHEMA",
    "DEFAULT_QOS_CLASSES",
    "TraceRecord",
    "write_trace",
    "read_trace",
    "to_requests",
    "records_of",
    "qos_poisson_trace",
]
