"""``ExecutionContext``: one immutable object for *how* a solve executes.

The scheduling API used to thread ``backend=str`` and ``cache=SolveCache``
positionally through every layer (solver engine → tape library → serving
queue → checkpoint restore → benchmarks → launchers), and each new execution
option (bucketing, numeric policy, …) meant another keyword replicated across
a dozen signatures.  :class:`ExecutionContext` bundles all of it:

* ``backend`` — execution engine: ``"python"`` (exact CPU, default),
  ``"cuda"`` (the hand-written CUDA wavefront kernel), ``"torch"`` (the same
  wavefront in eager torch — the plain version the kernel is held against,
  on any device);
* ``device`` — the torch device the ``"cuda"`` and ``"torch"`` backends put
  their tables on (default ``"cuda"``; pass ``"cpu"`` to run the ``"torch"``
  backend without a card).  The ``"python"`` backend ignores it;
* ``cache`` — an optional :class:`~repro_torch.core.cache.CacheBackend`
  memoising repeated solves of identical request multisets (and carrying
  advisory :class:`~repro_torch.core.warm.WarmState` objects for warm-started
  re-solves); :class:`~repro_torch.core.solver.SolveCache` is the in-process
  LRU default, :class:`~repro_torch.core.cache.JsonlCacheBackend` persists
  across restarts;
* ``bucketed`` — whether device batches go through the size-bucketed launch
  planner (``False`` reproduces the seed's single maximally-padded launch,
  kept for A/B benchmarking);
* ``cand_tile`` — candidate-chunk height override for the banded wavefront
  scan (``None`` = kernel default);
* ``numeric_policy`` — what to do when an instance fails the int32 device
  magnitude guard *after* gcd/shift rescaling: ``"strict"`` raises (default),
  ``"f64"`` falls back to an exact float64 table for just the failing
  instances (exact while every table value stays below 2**53);
* ``budget`` — an optional :class:`ComputeBudget` making solver compute a
  *priced* resource for the serving loop: how much virtual time one DP cell
  costs (so dispatches charge their solve work into the timeline), the
  per-tick cell budget a load-adaptive
  :class:`~repro_torch.core.solver.SolverSelector` plans against, the queue-depth
  thresholds of the ``depth-threshold`` selector, and the hysteresis tick
  count that keeps per-tick policy choices from flapping.  ``None``
  (default) prices nothing and charges nothing — every pre-budget timeline
  is reproduced bit for bit;
* ``obs`` — an optional :class:`~repro_torch.obs.Observability` bundle
  (tracer + metrics registry + kernel profile, see :mod:`repro_torch.obs`):
  instrumentation hooks throughout the solver, cache, drive pool and serving
  loop record into it.  ``None`` (default) records nothing, and every hook
  hands over already-computed exact integers, so instrumented and
  uninstrumented runs are bit-identical.

Contexts are frozen: derive variants with :meth:`ExecutionContext.replace`::

    ctx = ExecutionContext(backend="cuda", cache=SolveCache())
    res = solve(inst, policy="dp", context=ctx)
    strict = ctx.replace(numeric_policy="strict")

Every public scheduling entry point (``solve``/``solve_batch``, ``Solver``
implementations, ``TapeLibrary``, ``schedule_reads``, ``plan_restore``,
``OnlineTapeServer``/``serve_trace``) accepts ``context=``.  The pre-context
``backend=``/``cache=`` keywords still work everywhere but are deprecation
shims: they emit :class:`DeprecationWarning` and forward into a context via
:func:`resolve_context`, bit-identical to the old paths.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (solver imports us)
    from ..obs import Observability
    from .cache import CacheBackend

__all__ = [
    "BACKENDS",
    "DEFAULT_BACKEND",
    "NUMERIC_POLICIES",
    "ComputeBudget",
    "DEFAULT_BUDGET",
    "FleetOptions",
    "ExecutionContext",
    "DEFAULT_CONTEXT",
    "resolve_context",
]

BACKENDS = ("python", "torch", "cuda")
DEFAULT_BACKEND = "python"

#: int32-guard-failure handling: raise, or fall back to an exact f64 table.
NUMERIC_POLICIES = ("strict", "f64")


@dataclasses.dataclass(frozen=True)
class ComputeBudget:
    """Solver-compute accounting for the serving loop (exact virtual time).

    The paper's exact DP costs minutes at realistic strata, so under load
    the solver's own runtime is a service-time component.  A budget makes
    that cost explicit in the one unit the rest of the repo asserts on —
    exact integers of virtual time — via the DP *cell* counts every solve
    already reports (:class:`~repro_torch.core.warm.WarmStats`):

    * ``solve_time_num`` / ``solve_time_den`` — virtual time charged per
      evaluated DP cell, as an exact rational: a dispatch that evaluated
      ``c`` cells delays its service start by ``c * num // den``.  The
      default ``0/1`` charges nothing (timelines bit-identical to a
      budget-less run).
    * ``per_tick`` — DP-cell budget one dispatch tick may spend; the
      ``cost-model`` :class:`~repro_torch.core.solver.SolverSelector` picks the
      most exact policy whose predicted cell count fits.  ``None`` leaves
      the cost model unconstrained (it then always picks its most exact
      tier).
    * ``shallow_depth`` / ``deep_depth`` — queue-depth thresholds for the
      ``depth-threshold`` selector: exact DP at or below ``shallow_depth``,
      the cheapest tier at or above ``deep_depth``, the middle tier between.
    * ``hysteresis`` — how many *consecutive* dispatch ticks a selector
      must indicate a different policy before the serving loop switches to
      it (1 = switch immediately); keeps the per-tick choice from flapping
      when the queue depth oscillates around a threshold.
    """

    solve_time_num: int = 0
    solve_time_den: int = 1
    per_tick: int | None = None
    shallow_depth: int = 4
    deep_depth: int = 16
    hysteresis: int = 2

    def __post_init__(self) -> None:
        if self.solve_time_num < 0:
            raise ValueError("solve_time_num must be >= 0")
        if self.solve_time_den < 1:
            raise ValueError("solve_time_den must be >= 1")
        if self.per_tick is not None and self.per_tick < 1:
            raise ValueError("per_tick must be >= 1 (or None for unlimited)")
        if not (1 <= self.shallow_depth <= self.deep_depth):
            raise ValueError(
                "need 1 <= shallow_depth <= deep_depth "
                f"(got {self.shallow_depth} / {self.deep_depth})"
            )
        if self.hysteresis < 1:
            raise ValueError("hysteresis must be >= 1 tick")

    def charge(self, cells: int) -> int:
        """Virtual time charged for ``cells`` evaluated DP cells (exact)."""
        return cells * self.solve_time_num // self.solve_time_den

    def replace(self, **changes) -> "ComputeBudget":
        """A copy with the given fields changed (budgets are immutable)."""
        return dataclasses.replace(self, **changes)


#: The default budget selectors fall back on when the context carries none:
#: free compute (no solve-time charge), unlimited per-tick cells, and the
#: stock depth thresholds / 2-tick hysteresis.
DEFAULT_BUDGET = ComputeBudget()


@dataclasses.dataclass(frozen=True)
class FleetOptions:
    """Federation shape for the fleet serving layer (:mod:`repro_torch.fleet`).

    Rides :class:`ExecutionContext` so launchers and helpers can thread the
    federation configuration through the same object that already carries
    backend/cache/budget choices: ``n_shards`` per-library shards, the
    registered placement strategy name routing each
    request, and the replication factor seeded fleet archives store each
    logical file at.  The defaults describe the degenerate one-shard
    federation whose timeline is pinned bit-identical to a standalone
    online tape server; a context without fleet
    options (``fleet=None``, the default) behaves identically everywhere.
    """

    n_shards: int = 1
    placement: str = "single"
    replicas: int = 1

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if not self.replicas or self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.replicas > self.n_shards:
            raise ValueError(
                f"replication factor {self.replicas} exceeds "
                f"n_shards={self.n_shards}"
            )
        if not self.placement or not isinstance(self.placement, str):
            raise ValueError("placement must be a registered strategy name")

    def replace(self, **changes) -> "FleetOptions":
        """A copy with the given fields changed (options are immutable)."""
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ExecutionContext:
    """Immutable bundle of execution options for the scheduling API."""

    backend: str = DEFAULT_BACKEND
    cache: "CacheBackend | None" = None
    bucketed: bool = True
    cand_tile: int | None = None
    numeric_policy: str = "strict"
    budget: ComputeBudget | None = None
    fleet: FleetOptions | None = None
    obs: "Observability | None" = None
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise KeyError(
                f"unknown backend {self.backend!r}; choose from {BACKENDS}"
            )
        if self.numeric_policy not in NUMERIC_POLICIES:
            raise ValueError(
                f"unknown numeric_policy {self.numeric_policy!r}; "
                f"choose from {NUMERIC_POLICIES}"
            )
        if self.cand_tile is not None and self.cand_tile < 1:
            raise ValueError("cand_tile must be >= 1 (or None for the default)")
        if self.budget is not None and not isinstance(self.budget, ComputeBudget):
            raise TypeError(f"budget must be a ComputeBudget, got {self.budget!r}")
        if self.fleet is not None and not isinstance(self.fleet, FleetOptions):
            raise TypeError(f"fleet must be a FleetOptions, got {self.fleet!r}")
        if self.obs is not None:
            # lazy import: repro_torch.obs pulls in serving helpers at call
            # time, and contexts are constructed during core package import
            from ..obs import Observability

            if not isinstance(self.obs, Observability):
                raise TypeError(
                    f"obs must be an Observability bundle, got {self.obs!r}"
                )
        if not isinstance(self.device, str) or not self.device:
            raise TypeError(f"device must be a torch device string, got {self.device!r}")

    def replace(self, **changes) -> "ExecutionContext":
        """A copy with the given fields changed (contexts are immutable)."""
        return dataclasses.replace(self, **changes)


#: The default context: python backend, no cache, bucketed, strict numerics.
DEFAULT_CONTEXT = ExecutionContext()


def resolve_context(
    context: ExecutionContext | None = None,
    *,
    backend: str | None = None,
    cache: "CacheBackend | None" = None,
    default: ExecutionContext | None = None,
    stacklevel: int = 3,
) -> ExecutionContext:
    """Merge legacy ``backend=``/``cache=`` keywords into a context.

    This is the single deprecation shim behind every migrated signature:
    ``context`` wins when given; otherwise legacy keywords (if any) emit one
    :class:`DeprecationWarning` and are folded over ``default`` (the enclosing
    object's context, or :data:`DEFAULT_CONTEXT`).  Results are bit-identical
    to the pre-context code paths — only the plumbing changed.
    """
    base = default if default is not None else DEFAULT_CONTEXT
    if context is not None:
        if backend is not None or cache is not None:
            raise TypeError(
                "pass either context= or the deprecated backend=/cache= "
                "keywords, not both"
            )
        return context
    if backend is None and cache is None:
        return base
    legacy = [k for k, v in (("backend", backend), ("cache", cache)) if v is not None]
    warnings.warn(
        f"the {'/'.join(legacy)} keyword(s) are deprecated; pass "
        f"context=ExecutionContext(...) instead (see repro_torch.core.context)",
        DeprecationWarning,
        stacklevel=stacklevel,
    )
    changes: dict = {}
    if backend is not None:
        changes["backend"] = backend
    if cache is not None:
        changes["cache"] = cache
    return base.replace(**changes)
