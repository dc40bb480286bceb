"""First-class solver engine: a ``Solver`` protocol + policy registry.

Every scheduling caller (``storage/tape.py`` and, as they are ported, the
serving loop, benchmarks and launchers) dispatches through this module
instead of a flat name→lambda dict.  A *policy* names an algorithm
from the paper (``"dp"``, ``"simpledp"``, ``"logdp1"``, heuristics …); an
:class:`~repro_torch.core.context.ExecutionContext` says *how* to run it — which
backend, which solve memo, bucketing and numeric options:

* ``"python"`` — exact Python-int CPU implementation (default, always
  available, arbitrary magnitudes);
* ``"cuda"`` — the hand-written CUDA wavefront kernel on the context's
  ``device`` (int32-exact under the magnitude guard in
  :mod:`repro_torch.kernels.ltsp_dp.ops`, float64-exact under
  ``numeric_policy="f64"``); raises without a CUDA device;
* ``"torch"`` — the kernel's plain eager-torch version, bit-identical to
  it, on any ``device`` (``ExecutionContext(backend="torch",
  device="cpu")`` runs without a card).

The device backends return full ``(cost, detours)`` solutions via the
kernel's argmin planes + host traceback, and batch several instances into a
few size-bucketed launches through :meth:`Solver.solve_batch`.  The DP family
*and* SIMPLEDP run on all three backends (SIMPLEDP clips the wavefront's
candidate band to root-level detours — the disjoint-detour restriction — via
the same mechanism that clips LOGDP spans); the list heuristics are
python-only.

Usage::

    from repro_torch.core import ExecutionContext, solve, solve_batch

    ctx = ExecutionContext(backend="cuda", cache=SolveCache())
    res = solve(inst, policy="dp", context=ctx)
    res.cost, res.detours

The pre-context keywords (``solve(inst, policy, backend="...", cache=...)``)
remain available as deprecation shims: they emit ``DeprecationWarning`` and
forward into a context, bit-identical to the old paths.

Registering a custom policy::

    from repro_torch.core.solver import DPSolver, register_solver

    register_solver(DPSolver("logdp2", kind="restricted-dp",
                             span_policy=lambda n_req: logdp_span(n_req, 2.0),
                             description="LOGDP with lambda=2"))

Memoising repeated solves: the ``CacheBackend`` protocol
--------------------------------------------------------
Serving and restore loops frequently re-plan *identical* tapes (the same
request multiset against the same cartridge).  ``ExecutionContext.cache``
accepts any object implementing the
:class:`~repro_torch.core.cache.CacheBackend` protocol —
``get``/``put``/``stats``/``clear``/``__len__`` over canonicalized solve
keys, plus ``get_warm``/``put_warm`` for carrying
:class:`~repro_torch.core.warm.WarmState` objects alongside the memoised full
solves.  :class:`SolveCache` (in-process bounded LRU) is the default
implementation; :class:`~repro_torch.core.cache.JsonlCacheBackend` adds an
append-only on-disk journal so a restarted serving fleet rewarms from its
previous runs.  Backends only ever memoise exact results, so swapping one
for another (or bounding one below the working set) changes wall time, never
a single schedule — asserted in the cache-eviction serving tests.

The cache key is the **canonicalized request multiset** plus the full
result-affecting execution fingerprint: ``(policy, backend, numeric_policy,
cand_tile, m, u_turn, left.tobytes(), right.tobytes(), mult.tobytes())``.
An :class:`~repro_torch.core.instance.Instance` already stores requested files
sorted by position with aggregated multiplicities, so two request batches
that read the same files the same number of times on the same cartridge
canonicalize to the same key regardless of arrival order.  The key captures
array *contents* at call time and hits return a fresh :class:`SolveResult`
(detours copied), so mutating an instance or a returned schedule never
aliases into — or invalidates silently — a cached entry.  ``backend`` is
part of the key because a hit reports the backend that actually computed
it.  ``numeric_policy`` and ``cand_tile`` are part of the key for the same
provenance reason, with a sharper edge: every backend/policy/tile
combination is bit-identical *where it computes at all*, but their error
domains differ — a strict-policy call must raise the int32-guard error on a
wide instance, not silently consume a result an f64-policy call cached
earlier, and a cached result must never claim it was computed under a tile
configuration that never ran.  (Earlier revisions deliberately excluded
both; the serving stack now distinguishes numeric configurations per
cartridge, so the aliasing became an observable bug.)  Only ``bucketed``
stays out of the key: it is launch *packing*, invisible in the result and
carrying no error-domain of its own.

The legacy ``ALGORITHMS`` mapping is kept as a read-only view over the
registry (name → ``inst -> detours`` callable) for downstream code that only
wants detour lists.

Degradation chain (fault tolerance)
-----------------------------------
Device backends can fault transiently (a wedged accelerator runtime, a
driver hiccup — modelled by :class:`TransientSolverError`).  Because every
backend is bit-identical where it computes at all, a faulting backend can be
*degraded* through :data:`DEGRADATION_CHAIN` — ``cuda → torch → python``
— without changing a single schedule:
:func:`solve_warm_degraded` / :func:`solve_batch_warm_degraded` retry each
tier up to ``attempts_per_backend`` times and fall through to the next on a
:class:`TransientSolverError` or :class:`UnsupportedBackendError`, dropping
any incoming warm state on the first fallback (warm states are not
guaranteed portable across tiers) and returning none themselves after one —
invalidation is the safe direction for an advisory accelerator.  The
``python`` tier is the last resort (always available, arbitrary
magnitudes); if even it faults, the typed :class:`SolverUnavailableError`
carries the per-tier failure history.  The memo cache keys on the backend
that actually computed, so a degraded result can never be served to a
healthy-backend call later.

Per-instance failures in a batch: :func:`solve_batch` is all-or-nothing by
default, but ``partial=True`` solves the good instances and returns a typed
:class:`FailedSolve` (policy, backend, index, error) in place of each bad
one — nothing failing ever touches the cache.

Warm-started solving
--------------------
:func:`solve_warm`/:func:`solve_batch_warm` mirror :func:`solve`/
:func:`solve_batch` but additionally thread a
:class:`~repro_torch.core.warm.WarmState` per instance: pass the state returned by
the previous solve of a perturbed sibling (same cartridge, one request
added/completed/aborted) and the DP re-evaluates only the invalidated cells
— bit-identical results, with exact evaluated/reused cell counters in the
returned :class:`~repro_torch.core.warm.WarmStats`.  Policies advertise support
via ``Solver.supports_warm`` (the DP family: ``dp``/``logdp*``); unsupported
policies fall back to a plain full solve with ``mode="unsupported"``.

Load-adaptive solver selection (``SolverSelector``)
---------------------------------------------------
Under heavy traffic the exact DP's own runtime becomes a service-time
component (the paper's DP costs minutes at the median CC-IN2P3 stratum), and
the approximate-sequencing quality bounds justify degrading to restricted DP
or heuristics while queues are deep.  A :class:`SolverSelector` is consulted
by the online serving loop at every dispatch tick with
a :class:`LoadView` (queue depth, batch size, recorded per-policy solve
timings) and the context's :class:`~repro_torch.core.context.ComputeBudget`, and
answers with the policy to solve that tick with — or ``None`` to keep the
server's configured policy.  Three selectors are registered:

* ``"fixed"`` — always the server's configured policy (the adaptive plumbing
  with adaptation turned off; bit-identical to no selector at all);
* ``"depth-threshold"`` — walks :data:`DEFAULT_LADDER` (``dp`` → ``logdp1``
  → ``nfgs``) by queue depth against ``budget.shallow_depth`` /
  ``budget.deep_depth``;
* ``"cost-model"`` — predicts each ladder tier's DP-cell cost for the tick's
  batch size via :func:`predict_cells` (observed cells-per-``n³`` from the
  run's own solve timings, with analytic priors before any observation) and
  picks the most exact tier that fits ``budget.per_tick``.

The *server* applies ``budget.hysteresis`` (a tier must win that many
consecutive ticks before the active policy switches), so selectors stay
stateless and replayable.  Register custom selectors with
:func:`register_selector`; ``list_selectors()`` enumerates.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import OrderedDict
from collections.abc import Mapping
from typing import Callable, Protocol, runtime_checkable

from ..obs.trace import HOST_SPANS
from .context import (
    BACKENDS,
    DEFAULT_BACKEND,
    DEFAULT_BUDGET,
    DEFAULT_CONTEXT,
    ComputeBudget,
    ExecutionContext,
    resolve_context,
)
from .dp import dp_schedule, dp_schedule_warm, logdp_span, simpledp_schedule
from .heuristics import fgs, gs, lognfgs, nfgs, no_detour
from .instance import Instance
from .schedule import evaluate_detours
from .warm import WarmState, WarmStats

__all__ = [
    "BACKENDS",
    "DEFAULT_BACKEND",
    "ExecutionContext",
    "DEFAULT_CONTEXT",
    "UnsupportedBackendError",
    "TransientSolverError",
    "SolverUnavailableError",
    "DEGRADATION_CHAIN",
    "degraded_backends",
    "FallbackRecord",
    "FailedSolve",
    "SolveResult",
    "SolveCache",
    "Solver",
    "HeuristicSolver",
    "DPSolver",
    "SimpleDPSolver",
    "register_solver",
    "get_solver",
    "list_solvers",
    "solve",
    "solve_batch",
    "solve_warm",
    "solve_batch_warm",
    "solve_warm_degraded",
    "solve_batch_warm_degraded",
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


class UnsupportedBackendError(ValueError):
    """A registered policy was asked for a backend it does not implement.

    Typed (callers can catch it without string-matching) and message-stable:
    the message is always ``policy {name!r} has no {backend!r} backend
    (supported: {backends})`` — tests and serving fallback paths rely on the
    format.  Raised *before* any instance is solved, so a batch never fails
    mid-flight: ``solve_batch`` on an unsupported policy/backend combination
    is all-or-nothing.
    """

    def __init__(self, policy: str, backend: str, supported: tuple[str, ...]):
        self.policy = policy
        self.backend = backend
        self.supported = supported
        super().__init__(
            f"policy {policy!r} has no {backend!r} backend "
            f"(supported: {supported})"
        )


class TransientSolverError(RuntimeError):
    """A backend faulted transiently (device wedge, runtime hiccup).

    Retryable by construction: the same solve on the same backend may
    succeed on the next attempt, and any other tier of
    :data:`DEGRADATION_CHAIN` computes the bit-identical result.  Raised by
    fault-injection hooks and catchable by :func:`solve_warm_degraded`.
    """

    def __init__(self, backend: str, message: str | None = None):
        self.backend = backend
        super().__init__(
            message or f"transient solver fault on backend {backend!r}"
        )


class SolverUnavailableError(RuntimeError):
    """Every tier of the degradation chain failed for this solve."""

    def __init__(self, policy: str, backend: str, failed: tuple[str, ...]):
        self.policy = policy
        self.backend = backend
        self.failed = failed
        super().__init__(
            f"policy {policy!r} could not be solved on any backend tier "
            f"(requested {backend!r}; attempts failed on: {list(failed)})"
        )


#: backend tiers in degradation order: the CUDA kernel, its plain torch
#: version, pure-Python exact DP (the always-available last resort).  Only
#: typed transient/unsupported errors walk it: a kernel that fails to build
#: or launch raises through.
DEGRADATION_CHAIN = ("cuda", "torch", "python")


def degraded_backends(backend: str) -> tuple[str, ...]:
    """The degradation-chain suffix starting at ``backend``."""
    if backend not in DEGRADATION_CHAIN:
        raise ValueError(
            f"unknown backend {backend!r}; chain is {DEGRADATION_CHAIN}"
        )
    return DEGRADATION_CHAIN[DEGRADATION_CHAIN.index(backend):]


@dataclasses.dataclass(frozen=True)
class FallbackRecord:
    """How a degraded solve landed: requested tier, used tier, fault trail.

    ``failed`` lists the backend of every faulted attempt in order (a tier
    retried twice before falling through appears twice); ``used ==
    requested`` with a non-empty trail means retries on the requested tier
    eventually succeeded — no fallback happened.
    """

    requested: str
    used: str
    failed: tuple[str, ...] = ()

    @property
    def n_faults(self) -> int:
        return len(self.failed)

    @property
    def fell_back(self) -> bool:
        return self.used != self.requested


@dataclasses.dataclass(frozen=True)
class FailedSolve:
    """Typed per-instance failure returned by ``solve_batch(partial=True)``.

    Sits in the result list at the failing instance's position; ``index``
    is that position in the input batch, ``error`` the exception the solve
    raised.  Never cached.
    """

    policy: str
    backend: str
    index: int
    error: Exception


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """One solved instance: the policy's reported cost and its detour list.

    ``cost`` includes *VirtualLB* (it is the LTSP objective of ``detours`` —
    the parity tests assert it equals the exact simulator score).
    """

    policy: str
    backend: str
    cost: int
    detours: list[tuple[int, int]]


class SolveCache:
    """Bounded LRU memo of solved instances (see the module docstring).

    The reference :class:`~repro_torch.core.cache.CacheBackend` implementation.
    Keys canonicalize the request multiset plus ``(policy, backend,
    numeric_policy, cand_tile)``; values are immutable snapshots (detours
    stored as tuples), re-materialised into a fresh :class:`SolveResult` on
    every hit.  ``hits``/``misses`` counters feed the benchmark summaries.
    A separate, independently bounded LRU side-table carries per-cartridge
    :class:`~repro_torch.core.warm.WarmState` objects
    (:meth:`get_warm`/:meth:`put_warm`) — warm states are advisory (any
    solve is exact without one), so they are never persisted and evicting
    one costs a little extra DP work, never correctness.
    """

    def __init__(self, maxsize: int = 4096, warm_maxsize: int = 512):
        self.maxsize = maxsize
        self.warm_maxsize = warm_maxsize
        self.hits = 0
        self.misses = 0
        self._store: OrderedDict[tuple, tuple] = OrderedDict()
        self._warm: OrderedDict[tuple, object] = OrderedDict()
        # observability sink (the serving loop points this at the context's
        # bundle; None records nothing and the counters above stay canonical)
        self.obs = None

    @staticmethod
    def key(
        inst: Instance,
        policy: str,
        backend: str,
        numeric_policy: str = "strict",
        cand_tile: int | None = None,
    ) -> tuple:
        """Canonical cache key; captures array contents at call time."""
        return (
            policy,
            backend,
            numeric_policy,
            cand_tile,
            inst.m,
            inst.u_turn,
            inst.left.tobytes(),
            inst.right.tobytes(),
            inst.mult.tobytes(),
        )

    def __len__(self) -> int:
        return len(self._store)

    def get(
        self,
        inst: Instance,
        policy: str,
        backend: str,
        numeric_policy: str = "strict",
        cand_tile: int | None = None,
    ) -> SolveResult | None:
        key = self.key(inst, policy, backend, numeric_policy, cand_tile)
        entry = self._store.get(key)
        if entry is None:
            self.misses += 1
            if self.obs is not None:
                self.obs.inc("cache_misses_total", cache=type(self).__name__)
            return None
        self._store.move_to_end(key)
        self.hits += 1
        if self.obs is not None:
            self.obs.inc("cache_hits_total", cache=type(self).__name__)
        cost, detours = entry
        return SolveResult(policy, backend, cost, [tuple(d) for d in detours])

    def put(
        self,
        inst: Instance,
        policy: str,
        backend: str,
        res: SolveResult,
        numeric_policy: str = "strict",
        cand_tile: int | None = None,
    ) -> None:
        key = self.key(inst, policy, backend, numeric_policy, cand_tile)
        self._store[key] = (
            res.cost,
            tuple((int(c), int(b)) for c, b in res.detours),
        )
        while len(self._store) > self.maxsize:
            self._store.popitem(last=False)
            if self.obs is not None:
                self.obs.inc("cache_evictions_total", cache=type(self).__name__)

    # -- warm-state side-table (advisory, in-memory only) ---------------------
    def get_warm(self, key: tuple):
        """The stored :class:`WarmState` for ``key`` (e.g. a cartridge id)."""
        state = self._warm.get(key)
        if state is not None:
            self._warm.move_to_end(key)
        return state

    def put_warm(self, key: tuple, state) -> None:
        self._warm[key] = state
        while len(self._warm) > self.warm_maxsize:
            self._warm.popitem(last=False)

    def stats(self) -> dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "entries": len(self),
            "warm_entries": len(self._warm),
        }

    def clear(self) -> None:
        self._store.clear()
        self._warm.clear()
        self.hits = 0
        self.misses = 0


def _as_context(context: ExecutionContext | str) -> ExecutionContext:
    """Deprecation shim: accept a bare backend string where a context is due.

    Pre-context code called ``solver.solve(inst, "torch")``; that
    keeps working (one ``DeprecationWarning``, then the string becomes the
    context's backend) so the seed surface is source-compatible.
    """
    if isinstance(context, ExecutionContext):
        return context
    warnings.warn(
        "passing a backend string to Solver.solve/solve_batch is deprecated; "
        "pass context=ExecutionContext(backend=...) instead",
        DeprecationWarning,
        stacklevel=3,
    )
    return DEFAULT_CONTEXT.replace(backend=context)


def _device_kwargs(ctx: ExecutionContext, disjoint: bool = False) -> dict:
    """Kernel options a device-backed solver derives from the context."""
    kwargs: dict = {
        "backend": ctx.backend,
        "device": ctx.device,
        "numeric_policy": ctx.numeric_policy,
    }
    if disjoint:
        kwargs["disjoint"] = True
    if ctx.cand_tile is not None:
        kwargs["cand_tile"] = ctx.cand_tile
    if ctx.obs is not None and ctx.obs.kernel is not None:
        kwargs["profile"] = ctx.obs.kernel
    return kwargs


@runtime_checkable
class Solver(Protocol):
    """Protocol every registered policy implements."""

    name: str
    kind: str  # "heuristic" | "restricted-dp" | "exact-dp"
    description: str

    @property
    def backends(self) -> tuple[str, ...]:
        """Backends this solver accepts (subset of :data:`BACKENDS`)."""

    @property
    def supports_device(self) -> bool:
        """Capability flag: True iff the ``cuda``/``torch`` backends are
        implemented."""

    @property
    def supports_warm(self) -> bool:
        """Capability flag: True iff warm-start re-solve is implemented.

        Warm-capable solvers additionally expose ``solve_warm`` /
        ``solve_batch_warm`` with the :func:`solve_warm` module-function
        signatures (minus policy/cache handling).
        """

    def solve(
        self, inst: Instance, context: ExecutionContext = DEFAULT_CONTEXT
    ) -> SolveResult:
        """Solve one instance under the given execution context."""

    def solve_batch(
        self, instances: list[Instance], context: ExecutionContext = DEFAULT_CONTEXT
    ) -> list[SolveResult]:
        """Solve several instances (device backends: bucketed launches)."""


def _check_backend(solver: "Solver", backend: str) -> None:
    if backend not in BACKENDS:
        raise KeyError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend not in solver.backends:
        raise UnsupportedBackendError(solver.name, backend, solver.backends)


@dataclasses.dataclass(frozen=True)
class HeuristicSolver:
    """Detour-list heuristic (NODETOUR/GS/FGS/NFGS/…); python backend only.

    The reported cost is the exact simulator score of the emitted detours.
    """

    name: str
    fn: Callable[[Instance], list[tuple[int, int]]]
    description: str = ""
    kind: str = "heuristic"

    @property
    def backends(self) -> tuple[str, ...]:
        return ("python",)

    @property
    def supports_device(self) -> bool:
        return False

    @property
    def supports_warm(self) -> bool:
        return False

    def solve(
        self, inst: Instance, context: ExecutionContext | str = DEFAULT_CONTEXT
    ) -> SolveResult:
        ctx = _as_context(context)
        _check_backend(self, ctx.backend)
        detours = self.fn(inst)
        return SolveResult(
            self.name, ctx.backend, evaluate_detours(inst, detours), detours
        )

    def solve_batch(
        self,
        instances: list[Instance],
        context: ExecutionContext | str = DEFAULT_CONTEXT,
    ) -> list[SolveResult]:
        ctx = _as_context(context)
        _check_backend(self, ctx.backend)  # all-or-nothing: never fail mid-batch
        return [self.solve(inst, ctx) for inst in instances]


@dataclasses.dataclass(frozen=True)
class DPSolver:
    """The paper's exact DP, optionally span-restricted (LOGDP family).

    ``span_policy`` maps ``n_req`` to the maximum detour span (``None`` =
    unrestricted = exact DP).  All three backends are available; the device
    backends batch by span value so one launch serves every instance that
    shares a span, and honour the context's bucketing/numeric options.
    """

    name: str
    span_policy: Callable[[int], int | None] | None = None
    description: str = ""
    kind: str = "exact-dp"

    @property
    def backends(self) -> tuple[str, ...]:
        return BACKENDS

    @property
    def supports_device(self) -> bool:
        return True

    @property
    def supports_warm(self) -> bool:
        return True

    def _span(self, inst: Instance) -> int | None:
        return None if self.span_policy is None else self.span_policy(inst.n_req)

    def solve(
        self, inst: Instance, context: ExecutionContext | str = DEFAULT_CONTEXT
    ) -> SolveResult:
        ctx = _as_context(context)
        _check_backend(self, ctx.backend)
        if ctx.backend == "python":
            cost, detours = dp_schedule(inst, span=self._span(inst))
        else:
            from ..kernels.ltsp_dp.ops import ltsp_solve_instance

            cost, detours = ltsp_solve_instance(
                inst, span=self._span(inst), **_device_kwargs(ctx)
            )
        return SolveResult(self.name, ctx.backend, cost, detours)

    def solve_batch(
        self,
        instances: list[Instance],
        context: ExecutionContext | str = DEFAULT_CONTEXT,
    ) -> list[SolveResult]:
        ctx = _as_context(context)
        _check_backend(self, ctx.backend)
        if ctx.backend == "python":
            return [self.solve(inst, ctx) for inst in instances]
        from ..kernels.ltsp_dp.ops import ltsp_solve_batch

        # one bucketed launch set per distinct span (the span is a static
        # kernel parameter; unrestricted DP always groups into one set)
        groups: dict[int | None, list[int]] = {}
        for i, inst in enumerate(instances):
            groups.setdefault(self._span(inst), []).append(i)
        results: list[SolveResult | None] = [None] * len(instances)
        for span, idxs in groups.items():
            solved = ltsp_solve_batch(
                [instances[i] for i in idxs],
                span=span,
                bucketed=ctx.bucketed,
                **_device_kwargs(ctx),
            )
            for i, (cost, detours) in zip(idxs, solved):
                results[i] = SolveResult(self.name, ctx.backend, cost, detours)
        return results  # type: ignore[return-value]

    def solve_warm(
        self,
        inst: Instance,
        context: ExecutionContext | str = DEFAULT_CONTEXT,
        warm=None,
    ):
        """Warm-startable solve: ``(SolveResult, new WarmState, WarmStats)``.

        Bit-identical to :meth:`solve` whatever ``warm`` holds (asserted
        differentially in the tests); the state/counters travel alongside.
        """
        ctx = _as_context(context)
        _check_backend(self, ctx.backend)
        if ctx.backend == "python":
            cost, detours, new_warm, stats = dp_schedule_warm(
                inst, span=self._span(inst), warm=warm
            )
        else:
            from ..kernels.ltsp_dp.ops import ltsp_solve_instance_warm

            cost, detours, new_warm, stats = ltsp_solve_instance_warm(
                inst, span=self._span(inst), warm=warm, **_device_kwargs(ctx)
            )
        return SolveResult(self.name, ctx.backend, cost, detours), new_warm, stats

    def solve_batch_warm(
        self,
        instances: list[Instance],
        context: ExecutionContext | str = DEFAULT_CONTEXT,
        warms=None,
    ):
        """Batch :meth:`solve_warm`; device backends group launches by span."""
        ctx = _as_context(context)
        _check_backend(self, ctx.backend)
        if warms is None:
            warms = [None] * len(instances)
        if ctx.backend == "python":
            out = [self.solve_warm(inst, ctx, warm=w)
                   for inst, w in zip(instances, warms)]
            return ([r for r, _, _ in out], [w for _, w, _ in out],
                    [s for _, _, s in out])
        from ..kernels.ltsp_dp.ops import ltsp_solve_batch_warm

        groups: dict[int | None, list[int]] = {}
        for i, inst in enumerate(instances):
            groups.setdefault(self._span(inst), []).append(i)
        results: list[SolveResult | None] = [None] * len(instances)
        new_warms: list = [None] * len(instances)
        stats: list = [None] * len(instances)
        for span, idxs in groups.items():
            solved, ws, sts = ltsp_solve_batch_warm(
                [instances[i] for i in idxs],
                [warms[i] for i in idxs],
                span=span,
                bucketed=ctx.bucketed,
                **_device_kwargs(ctx),
            )
            for i, (cost, detours), w, st in zip(idxs, solved, ws, sts):
                results[i] = SolveResult(self.name, ctx.backend, cost, detours)
                new_warms[i], stats[i] = w, st
        return results, new_warms, stats


@dataclasses.dataclass(frozen=True)
class SimpleDPSolver:
    """SIMPLEDP (disjoint detours, 2-D table); all three backends.

    The python backend evaluates the dedicated 2-D recursion
    (:func:`repro_torch.core.dp.simpledp_schedule`).  The device backends reuse the
    full wavefront kernel with its candidate band clipped to root-level cells
    (``disjoint=True``) — forbidding detours inside detours collapses the 3-D
    table to SIMPLEDP's exactly (same mechanism as the LOGDP span clip), so
    cost *and* traceback are bit-identical to the python recursion.
    """

    name: str = "simpledp"
    description: str = "DP restricted to non-intertwined detours"
    kind: str = "restricted-dp"

    @property
    def backends(self) -> tuple[str, ...]:
        return BACKENDS

    @property
    def supports_device(self) -> bool:
        return True

    @property
    def supports_warm(self) -> bool:
        # the 2-D table collapses the first index: its cells are not the
        # 3-D cells WarmState stores, so transfer does not apply
        return False

    def solve(
        self, inst: Instance, context: ExecutionContext | str = DEFAULT_CONTEXT
    ) -> SolveResult:
        ctx = _as_context(context)
        _check_backend(self, ctx.backend)
        if ctx.backend == "python":
            cost, detours = simpledp_schedule(inst)
        else:
            from ..kernels.ltsp_dp.ops import ltsp_solve_instance

            cost, detours = ltsp_solve_instance(
                inst, **_device_kwargs(ctx, disjoint=True)
            )
        return SolveResult(self.name, ctx.backend, cost, detours)

    def solve_batch(
        self,
        instances: list[Instance],
        context: ExecutionContext | str = DEFAULT_CONTEXT,
    ) -> list[SolveResult]:
        ctx = _as_context(context)
        _check_backend(self, ctx.backend)
        if ctx.backend == "python":
            return [self.solve(inst, ctx) for inst in instances]
        from ..kernels.ltsp_dp.ops import ltsp_solve_batch

        solved = ltsp_solve_batch(
            instances, bucketed=ctx.bucketed, **_device_kwargs(ctx, disjoint=True)
        )
        return [
            SolveResult(self.name, ctx.backend, cost, detours)
            for cost, detours in solved
        ]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Solver] = {}


def register_solver(solver: Solver, overwrite: bool = False) -> Solver:
    """Add a solver to the registry (name collisions require ``overwrite``)."""
    if solver.name in _REGISTRY and not overwrite:
        raise ValueError(f"solver {solver.name!r} already registered")
    _REGISTRY[solver.name] = solver
    return solver


def get_solver(name: str) -> Solver:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; choose from {sorted(_REGISTRY)}"
        ) from None


def list_solvers() -> list[str]:
    """Registered policy names, in registration order."""
    return list(_REGISTRY)


def _root_attrs(sp, policy: str, ctx: ExecutionContext, instances: list[Instance],
                batch: bool) -> None:
    """An ``ltsp.solve`` root span's attributes: the policy, the backend and
    each instance's ``n_req`` and ``n`` (lists for a batch entry)."""
    n_req = [inst.n_req for inst in instances]
    n = [inst.n for inst in instances]
    if not batch:
        n_req, n = n_req[0], n[0]
    sp.attrs.update(policy=policy, backend=ctx.backend, n_req=n_req, n=n)


def solve(
    inst: Instance,
    policy: str = "dp",
    backend: str | None = None,
    cache: SolveCache | None = None,
    *,
    context: ExecutionContext | None = None,
) -> SolveResult:
    """Solve one instance with a registered policy.

    ``context`` carries the execution options (backend, memo cache, bucketing,
    numeric policy); ``backend=``/``cache=`` are the deprecated pre-context
    spellings and forward into one (with a ``DeprecationWarning``).
    """
    ctx = resolve_context(context, backend=backend, cache=cache)
    with HOST_SPANS.open("ltsp.solve") as sp:
        if sp:
            _root_attrs(sp, policy, ctx, [inst], batch=False)
        solver = get_solver(policy)
        _check_backend(solver, ctx.backend)  # before the cache: no miss-count pollution
        memo = ctx.cache
        if memo is not None:
            hit = memo.get(inst, policy, ctx.backend, ctx.numeric_policy, ctx.cand_tile)
            if hit is not None:
                return hit
        res = solver.solve(inst, ctx)
        if memo is not None:
            memo.put(inst, policy, ctx.backend, res, ctx.numeric_policy, ctx.cand_tile)
        return res


def solve_batch(
    instances: list[Instance],
    policy: str = "dp",
    backend: str | None = None,
    cache: SolveCache | None = None,
    *,
    context: ExecutionContext | None = None,
    partial: bool = False,
) -> list["SolveResult | FailedSolve"]:
    """Solve a batch; device backends pack it into size-bucketed launches.

    With a cache on the context, hits are served from the memo and only the
    misses go to the backend (in one bucketed batch), so re-planning a
    mostly-repeated request mix only pays for the novel tapes.

    An unsupported policy/backend combination raises
    :class:`UnsupportedBackendError` before any instance is solved or any
    cache entry is touched — a batch is all-or-nothing, never mid-flight.
    One *bad instance* (e.g. an int32-guard overflow under the strict
    numeric policy) is also all-or-nothing by default, but ``partial=True``
    relaxes that: the good instances are solved (and cached) normally while
    each failing one yields a typed :class:`FailedSolve` at its position —
    failures never pollute the cache, so a later retry (on another backend
    or numeric policy) starts clean.  ``backend=``/``cache=`` are
    deprecation shims, as in :func:`solve`.
    """
    ctx = resolve_context(context, backend=backend, cache=cache)
    with HOST_SPANS.open("ltsp.solve") as sp:
        if sp:
            _root_attrs(sp, policy, ctx, instances, batch=True)
        solver = get_solver(policy)
        _check_backend(solver, ctx.backend)
        memo = ctx.cache
        if memo is None and not partial:
            return solver.solve_batch(instances, ctx)
        results: list[SolveResult | FailedSolve | None] = [
            memo.get(inst, policy, ctx.backend, ctx.numeric_policy, ctx.cand_tile)
            if memo is not None
            else None
            for inst in instances
        ]
        miss = [i for i, r in enumerate(results) if r is None]
        if miss:
            solved: list[SolveResult | FailedSolve]
            if not partial:
                solved = solver.solve_batch([instances[i] for i in miss], ctx)
            else:
                try:
                    solved = solver.solve_batch([instances[i] for i in miss], ctx)
                except Exception:
                    # the fast whole-batch path failed somewhere mid-bucket:
                    # fall back to per-instance solves so the good ones survive
                    solved = []
                    for i in miss:
                        try:
                            solved.append(solver.solve(instances[i], ctx))
                        except Exception as err:  # noqa: BLE001 - typed re-wrap
                            solved.append(FailedSolve(policy, ctx.backend, i, err))
            for i, res in zip(miss, solved):
                if isinstance(res, SolveResult) and memo is not None:
                    memo.put(instances[i], policy, ctx.backend, res,
                             ctx.numeric_policy, ctx.cand_tile)
                results[i] = res
        return results  # type: ignore[return-value]


def solve_warm(
    inst: Instance,
    policy: str = "dp",
    *,
    context: ExecutionContext | None = None,
    warm: WarmState | None = None,
) -> tuple[SolveResult, WarmState | None, WarmStats]:
    """:func:`solve` with warm-start threading and exact work counters.

    Returns ``(result, new_warm, stats)``.  ``result`` is bit-identical to
    :func:`solve` — a warm state can only change *how much work* the solve
    performs, never its outcome (differentially asserted in the tests).
    ``new_warm`` is the state to pass into the next solve of a perturbed
    sibling instance (``None`` when the policy cannot produce one); on a
    cache hit the incoming ``warm`` is handed back unchanged — it stays
    valid, the alignment revalidates per file on the next miss.  ``stats``
    counts DP cells evaluated vs. reused (``mode="cache"`` marks a memo hit
    that did no DP work at all).
    """
    ctx = context if context is not None else DEFAULT_CONTEXT
    with HOST_SPANS.open("ltsp.solve") as sp:
        if sp:
            _root_attrs(sp, policy, ctx, [inst], batch=False)
        solver = get_solver(policy)
        _check_backend(solver, ctx.backend)
        memo = ctx.cache
        if memo is not None:
            hit = memo.get(inst, policy, ctx.backend, ctx.numeric_policy, ctx.cand_tile)
            if hit is not None:
                if ctx.obs is not None:
                    ctx.obs.inc(
                        "solves_total", policy=policy, backend=ctx.backend,
                        mode="cache",
                    )
                return hit, warm, WarmStats(mode="cache")
        if getattr(solver, "supports_warm", False):
            res, new_warm, stats = solver.solve_warm(inst, ctx, warm=warm)
        else:
            res, new_warm, stats = (
                solver.solve(inst, ctx), None, WarmStats(mode="unsupported")
            )
        if memo is not None:
            memo.put(inst, policy, ctx.backend, res, ctx.numeric_policy, ctx.cand_tile)
        if ctx.obs is not None:
            ctx.obs.inc(
                "solves_total", policy=policy, backend=ctx.backend, mode=stats.mode
            )
            ctx.obs.observe("solve_cells", stats.cells_evaluated, policy=policy)
        return res, new_warm, stats


def solve_batch_warm(
    instances: list[Instance],
    policy: str = "dp",
    *,
    context: ExecutionContext | None = None,
    warms: list[WarmState | None] | None = None,
) -> tuple[list[SolveResult], list[WarmState | None], list[WarmStats]]:
    """Batch :func:`solve_warm`: per-instance warm states in, results +
    fresh states + counters out (all parallel to ``instances``).

    Cache hits skip the solver and keep the incoming state, exactly like
    :func:`solve_warm`; misses go to the backend in one warm-aware batch.
    """
    ctx = context if context is not None else DEFAULT_CONTEXT
    with HOST_SPANS.open("ltsp.solve") as sp:
        if sp:
            _root_attrs(sp, policy, ctx, instances, batch=True)
        solver = get_solver(policy)
        _check_backend(solver, ctx.backend)
        if warms is None:
            warms = [None] * len(instances)
        memo = ctx.cache
        results: list[SolveResult | None] = [None] * len(instances)
        new_warms: list[WarmState | None] = list(warms)
        stats: list[WarmStats] = [WarmStats(mode="cache") for _ in instances]
        if memo is not None:
            for i, inst in enumerate(instances):
                results[i] = memo.get(
                    inst, policy, ctx.backend, ctx.numeric_policy, ctx.cand_tile
                )
        miss = [i for i, r in enumerate(results) if r is None]
        if miss:
            if getattr(solver, "supports_warm", False):
                solved, ws, sts = solver.solve_batch_warm(
                    [instances[i] for i in miss], ctx, warms=[warms[i] for i in miss]
                )
            else:
                solved = solver.solve_batch([instances[i] for i in miss], ctx)
                ws = [None] * len(miss)
                sts = [WarmStats(mode="unsupported") for _ in miss]
            for i, res, w, st in zip(miss, solved, ws, sts):
                if memo is not None:
                    memo.put(instances[i], policy, ctx.backend, res,
                             ctx.numeric_policy, ctx.cand_tile)
                results[i], new_warms[i], stats[i] = res, w, st
        if ctx.obs is not None:
            for st in stats:
                ctx.obs.inc(
                    "solves_total", policy=policy, backend=ctx.backend, mode=st.mode
                )
                ctx.obs.observe("solve_cells", st.cells_evaluated, policy=policy)
        return results, new_warms, stats  # type: ignore[return-value]


def solve_warm_degraded(
    inst: Instance,
    policy: str = "dp",
    *,
    context: ExecutionContext | None = None,
    warm: WarmState | None = None,
    fault_hook: Callable[[str], None] | None = None,
    attempts_per_backend: int = 1,
) -> tuple[SolveResult, WarmState | None, WarmStats, FallbackRecord]:
    """:func:`solve_warm` through the backend degradation chain.

    Walks :func:`degraded_backends` from the context's backend, retrying
    each tier up to ``attempts_per_backend`` times on a
    :class:`TransientSolverError` before falling through (an
    :class:`UnsupportedBackendError` falls through immediately — retrying
    cannot help).  ``fault_hook(backend)`` runs before every attempt; fault
    injectors raise :class:`TransientSolverError` from it.  Results are
    bit-identical across tiers, so only the :class:`FallbackRecord` tells a
    degraded solve from a healthy one.  After any fault the incoming warm
    state is dropped and no new one is returned (``new_warm is None``):
    warm states are advisory accelerators and invalidation is the safe
    direction across tiers.  Raises :class:`SolverUnavailableError` when
    every tier (including ``python``) failed.
    """
    ctx = context if context is not None else DEFAULT_CONTEXT
    failed: list[str] = []
    for b in degraded_backends(ctx.backend):
        bctx = ctx if b == ctx.backend else ctx.replace(backend=b)
        for _ in range(max(1, attempts_per_backend)):
            try:
                if fault_hook is not None:
                    fault_hook(b)
                res, new_warm, stats = solve_warm(
                    inst, policy, context=bctx,
                    warm=warm if not failed else None,
                )
            except UnsupportedBackendError:
                failed.append(b)
                break
            except TransientSolverError:
                failed.append(b)
                continue
            if failed:
                new_warm = None
            if ctx.obs is not None and failed:
                ctx.obs.inc("solver_faults_total", len(failed))
                if b != ctx.backend:
                    ctx.obs.inc("solver_fallbacks_total", backend=b)
            return res, new_warm, stats, FallbackRecord(
                requested=ctx.backend, used=b, failed=tuple(failed)
            )
    raise SolverUnavailableError(policy, ctx.backend, tuple(failed))


def solve_batch_warm_degraded(
    instances: list[Instance],
    policy: str = "dp",
    *,
    context: ExecutionContext | None = None,
    warms: list[WarmState | None] | None = None,
    fault_hook: Callable[[str], None] | None = None,
    attempts_per_backend: int = 1,
) -> tuple[
    list[SolveResult], list[WarmState | None], list[WarmStats], FallbackRecord
]:
    """:func:`solve_batch_warm` through the degradation chain.

    One batch is one launch and therefore one fault domain: a transient
    fault retries/degrades the *whole* batch (per-instance bad-input
    errors are :func:`solve_batch`'s ``partial=True`` concern, not a
    backend-health one).  Semantics otherwise match
    :func:`solve_warm_degraded`, including warm-state invalidation after
    any fault.
    """
    ctx = context if context is not None else DEFAULT_CONTEXT
    failed: list[str] = []
    for b in degraded_backends(ctx.backend):
        bctx = ctx if b == ctx.backend else ctx.replace(backend=b)
        for _ in range(max(1, attempts_per_backend)):
            try:
                if fault_hook is not None:
                    fault_hook(b)
                results, new_warms, stats = solve_batch_warm(
                    instances, policy, context=bctx,
                    warms=warms if not failed else None,
                )
            except UnsupportedBackendError:
                failed.append(b)
                break
            except TransientSolverError:
                failed.append(b)
                continue
            if failed:
                new_warms = [None] * len(instances)
            if ctx.obs is not None and failed:
                ctx.obs.inc("solver_faults_total", len(failed))
                if b != ctx.backend:
                    ctx.obs.inc("solver_fallbacks_total", backend=b)
            return results, new_warms, stats, FallbackRecord(
                requested=ctx.backend, used=b, failed=tuple(failed)
            )
    raise SolverUnavailableError(policy, ctx.backend, tuple(failed))


# the paper's nine policies
register_solver(HeuristicSolver("nodetour", no_detour, "single left-to-right sweep"))
register_solver(HeuristicSolver("gs", gs, "greedy: one atomic detour per file"))
register_solver(HeuristicSolver("fgs", fgs, "GS filtered by Lemma 3"))
register_solver(HeuristicSolver("nfgs", nfgs, "non-atomic FGS (corrected)"))
register_solver(
    HeuristicSolver(
        "lognfgs5", lambda inst: lognfgs(inst, lam=5.0), "NFGS, spans <= 5 ln n"
    )
)
register_solver(
    DPSolver(
        "logdp1",
        span_policy=lambda n_req: logdp_span(n_req, 1.0),
        description="DP, spans <= ln n",
        kind="restricted-dp",
    )
)
register_solver(
    DPSolver(
        "logdp5",
        span_policy=lambda n_req: logdp_span(n_req, 5.0),
        description="DP, spans <= 5 ln n",
        kind="restricted-dp",
    )
)
register_solver(SimpleDPSolver())
register_solver(DPSolver("dp", description="the paper's exact DP (optimal)"))


class _AlgorithmsView(Mapping):
    """Legacy ``ALGORITHMS`` shim: registry view as name → ``inst -> detours``.

    Prefer :func:`solve`/:func:`get_solver`; this exists so downstream code
    and the seed tests that only want detour lists keep working.
    """

    def __getitem__(self, name: str) -> Callable[[Instance], list[tuple[int, int]]]:
        solver = get_solver(name)
        if isinstance(solver, HeuristicSolver):
            return solver.fn  # detours directly, no throwaway simulator score
        return lambda inst: solver.solve(inst).detours

    def __iter__(self):
        return iter(_REGISTRY)

    def __len__(self) -> int:
        return len(_REGISTRY)


ALGORITHMS = _AlgorithmsView()


# ---------------------------------------------------------------------------
# Load-adaptive solver selection
# ---------------------------------------------------------------------------

#: Exactness ladder the built-in adaptive selectors walk, most exact first:
#: the paper's optimal DP, the log-span restricted DP, then the corrected
#: non-atomic filtered-greedy heuristic (cells-free).  Bachmat's
#: expected-tour-length asymptotics order these by cost as ~n^3 / ~n^2 log n
#: / ~n log n, which is exactly the shape :func:`predict_cells` assumes
#: before a run has recorded its own timings.
DEFAULT_LADDER = ("dp", "logdp1", "nfgs")


@dataclasses.dataclass(frozen=True)
class LoadView:
    """What a :class:`SolverSelector` sees at one dispatch tick.

    Built by the serving loop just before it solves a batch; selectors must
    treat it as read-only.  ``timings`` maps policy name to the run's
    accumulated ``(cells_evaluated, n_cubed)`` totals over real (non-cache)
    solves, the empirical basis for :func:`predict_cells`.
    """

    depth: int  #: queued requests behind this dispatch, incl. the batch
    n_requests: int  #: requests in the batch about to be solved
    now: int = 0  #: virtual time of the tick
    timings: Mapping[str, tuple[int, int]] = dataclasses.field(
        default_factory=dict
    )  #: policy -> (total cells evaluated, total n^3) observed this run


@runtime_checkable
class SolverSelector(Protocol):
    """Per-tick policy chooser for the serving loop.

    ``select`` answers with a registered policy name — or ``None`` to keep
    the server's configured policy.  Selectors are stateless: hysteresis
    (``budget.hysteresis`` consecutive ticks before a switch takes effect)
    is applied by the server so recovery replays re-derive identical
    choices from the journal alone.
    """

    name: str
    description: str
    ladder: tuple[str, ...]

    def select(
        self, view: LoadView, budget: ComputeBudget
    ) -> str | None: ...


def predict_cells(
    policy: str,
    n_requests: int,
    timings: Mapping[str, tuple[int, int]] | None = None,
) -> int:
    """Predicted DP cells a ``policy`` solve of ``n_requests`` will evaluate.

    With an observation for the policy in ``timings`` (accumulated
    ``(cells, n^3)`` totals from this run's real solves), scales the
    observed cells-per-``n^3`` ratio to the new size — exact integer
    arithmetic, ``cells * n^3 // observed_cubes``.  Without one, falls back
    to analytic priors by solver kind: heuristics evaluate no DP cells,
    restricted DP is ~``n^2 log n``, exact DP is ``n^3``.
    """
    solver = get_solver(policy)
    n = max(0, n_requests)
    if timings:
        observed = timings.get(solver.name)
        if observed is not None:
            cells, cubes = observed
            if cubes > 0:
                return cells * n**3 // cubes
    if solver.kind == "heuristic":
        return 0
    if solver.kind == "restricted-dp":
        return n * n * max(1, n.bit_length())
    return n**3


@dataclasses.dataclass(frozen=True)
class FixedSelector:
    """Always the same policy (``None`` = the server's configured one).

    The adaptive plumbing with adaptation turned off: with ``policy=None``
    every tick keeps the server's policy, so timelines are bit-identical to
    running with no selector at all — the control arm of the overload sweep.
    """

    policy: str | None = None
    name: str = "fixed"
    description: str = "always the server's configured policy"

    def __post_init__(self) -> None:
        if self.policy is not None:
            get_solver(self.policy)  # raises KeyError on unknown policies

    @property
    def ladder(self) -> tuple[str, ...]:
        return (self.policy,) if self.policy is not None else ()

    def select(self, view: LoadView, budget: ComputeBudget) -> str | None:
        return self.policy


def _check_ladder(ladder: tuple[str, ...]) -> tuple[str, ...]:
    ladder = tuple(ladder)
    if not ladder:
        raise ValueError("selector ladder must name at least one policy")
    for p in ladder:
        get_solver(p)  # raises KeyError on unknown policies
    return ladder


@dataclasses.dataclass(frozen=True)
class DepthThresholdSelector:
    """Walk the ladder by queue depth against the budget's thresholds.

    Depth at or below ``budget.shallow_depth`` plays the most exact tier,
    at or above ``budget.deep_depth`` the cheapest, in between the middle
    tier.  Crude but dependency-free: no timing observations needed.
    """

    ladder: tuple[str, ...] = DEFAULT_LADDER
    name: str = "depth-threshold"
    description: str = "exact DP when shallow, cheaper tiers as depth grows"

    def __post_init__(self) -> None:
        object.__setattr__(self, "ladder", _check_ladder(self.ladder))

    def select(self, view: LoadView, budget: ComputeBudget) -> str | None:
        if view.depth <= budget.shallow_depth:
            return self.ladder[0]
        if view.depth >= budget.deep_depth:
            return self.ladder[-1]
        return self.ladder[len(self.ladder) // 2]


@dataclasses.dataclass(frozen=True)
class CostModelSelector:
    """Most exact ladder tier whose predicted cell cost fits the budget.

    Estimates each tier's solve cost for the tick's batch size with
    :func:`predict_cells` — the run's own recorded solve timings once any
    exist, analytic priors before that — and returns the first (most exact)
    tier at or under ``budget.per_tick`` cells.  An unlimited budget
    (``per_tick=None``) always picks the most exact tier; if no tier fits,
    the cheapest is returned rather than refusing to serve.
    """

    ladder: tuple[str, ...] = DEFAULT_LADDER
    name: str = "cost-model"
    description: str = "most exact policy whose predicted cells fit per_tick"

    def __post_init__(self) -> None:
        object.__setattr__(self, "ladder", _check_ladder(self.ladder))

    def select(self, view: LoadView, budget: ComputeBudget) -> str | None:
        if budget.per_tick is None:
            return self.ladder[0]
        for policy in self.ladder:
            if predict_cells(policy, view.n_requests, view.timings) <= budget.per_tick:
                return policy
        return self.ladder[-1]


_SELECTORS: "OrderedDict[str, SolverSelector]" = OrderedDict()


def register_selector(selector: SolverSelector, *, replace: bool = False) -> None:
    """Add a selector to the registry (``replace=True`` to overwrite)."""
    name = getattr(selector, "name", "")
    if not name or not isinstance(name, str):
        raise ValueError(f"selector must carry a non-empty string name: {selector!r}")
    if not replace and name in _SELECTORS:
        raise ValueError(
            f"selector {name!r} is already registered (pass replace=True)"
        )
    _SELECTORS[name] = selector


def get_selector(name: "str | SolverSelector") -> SolverSelector:
    """Look up a registered selector by name (instances pass through)."""
    if not isinstance(name, str):
        if isinstance(name, SolverSelector):
            return name
        raise TypeError(f"not a selector name or SolverSelector: {name!r}")
    try:
        return _SELECTORS[name]
    except KeyError:
        raise KeyError(
            f"unknown selector {name!r}; choose from {list_selectors()}"
        ) from None


def list_selectors() -> tuple[str, ...]:
    """Registered selector names, in registration order."""
    return tuple(_SELECTORS)


register_selector(FixedSelector())
register_selector(DepthThresholdSelector())
register_selector(CostModelSelector())
