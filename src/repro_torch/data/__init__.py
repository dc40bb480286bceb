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
]
