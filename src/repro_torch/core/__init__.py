"""LTSP core: the paper's exact DP algorithm, heuristics, and evaluators.

Scheduling dispatch goes through the solver engine (:mod:`.solver`): pick a
*policy* (algorithm) and an :class:`ExecutionContext` (backend, solve memo,
bucketing/numeric options — see :mod:`.context`) via
:func:`solve`/:func:`solve_batch`, or register new policies with
:func:`repro_torch.core.solver.register_solver`.  The legacy ``ALGORITHMS`` mapping
is a thin read-only view over the registry; pre-context ``backend=``/
``cache=`` keywords survive as warning-emitting deprecation shims.
"""

from .context import (
    DEFAULT_BUDGET,
    DEFAULT_CONTEXT,
    NUMERIC_POLICIES,
    ComputeBudget,
    ExecutionContext,
    FleetOptions,
    resolve_context,
)
from .instance import Instance, make_instance, virtual_lb
from .schedule import (
    evaluate_detours,
    lower_bound_gap,
    no_detour_cost,
    schedule_makespan,
    service_times,
)
from .dp import (
    dp_schedule,
    dp_schedule_warm,
    dp_value,
    logdp_schedule,
    simpledp_schedule,
    logdp_span,
)
from .heuristics import no_detour, gs, fgs, nfgs, lognfgs
from .solver import (
    ALGORITHMS,
    BACKENDS,
    DEFAULT_LADDER,
    CostModelSelector,
    DepthThresholdSelector,
    FixedSelector,
    LoadView,
    SolveCache,
    SolveResult,
    Solver,
    SolverSelector,
    UnsupportedBackendError,
    get_selector,
    get_solver,
    list_selectors,
    list_solvers,
    predict_cells,
    register_selector,
    register_solver,
    solve,
    solve_batch,
    solve_batch_warm,
    solve_warm,
)
from .cache import CacheBackend, CacheLockedError, JsonlCacheBackend
from .warm import WarmState, WarmStats

__all__ = [
    "ExecutionContext",
    "DEFAULT_CONTEXT",
    "NUMERIC_POLICIES",
    "ComputeBudget",
    "DEFAULT_BUDGET",
    "FleetOptions",
    "resolve_context",
    "Instance",
    "make_instance",
    "virtual_lb",
    "evaluate_detours",
    "service_times",
    "no_detour_cost",
    "schedule_makespan",
    "lower_bound_gap",
    "dp_schedule",
    "dp_schedule_warm",
    "dp_value",
    "logdp_schedule",
    "simpledp_schedule",
    "logdp_span",
    "no_detour",
    "gs",
    "fgs",
    "nfgs",
    "lognfgs",
    "BACKENDS",
    "SolveCache",
    "SolveResult",
    "Solver",
    "UnsupportedBackendError",
    "register_solver",
    "get_solver",
    "list_solvers",
    "solve",
    "solve_batch",
    "solve_warm",
    "solve_batch_warm",
    "CacheBackend",
    "CacheLockedError",
    "JsonlCacheBackend",
    "WarmState",
    "WarmStats",
    "ALGORITHMS",
    "DEFAULT_LADDER",
    "LoadView",
    "SolverSelector",
    "predict_cells",
    "FixedSelector",
    "DepthThresholdSelector",
    "CostModelSelector",
    "register_selector",
    "get_selector",
    "list_selectors",
]
