"""Tape-tier model: linear cartridges + LTSP-scheduled batch reads.

This is the system integration of the paper: the framework's cold tier
(training corpora, checkpoint archives) lives on linear tape cartridges; any
batch of read requests against one cartridge is an LTSP instance, and the
mass-storage scheduler orders the reads with the paper's algorithms
(``policy="dp"`` optimal, ``"logdp*"``/``"simpledp"`` low-cost, plus all
baselines) to minimise the mean service time experienced by consumers.

Policy and execution context
----------------------------
Scheduling dispatches through the solver engine (:mod:`repro_torch.core.solver`):
``policy`` names any registered solver (``repro_torch.core.list_solvers()``) and an
:class:`~repro_torch.core.ExecutionContext` says how to run it — backend
(``"python"`` exact CPU, ``"cuda"`` hand-written CUDA wavefront, ``"torch"``
its plain eager-torch version), solve memo, bucketing and numeric-guard
policy.  A
:class:`TapeLibrary` owns a context (constructor ``context=``): every
:meth:`TapeLibrary.schedule` call uses it unless the call passes its own.
On the device backends :meth:`TapeLibrary.schedule` packs every cartridge's
instance into a few size-bucketed device launches
(:func:`repro_torch.core.solve_batch`) and reconstructs each cartridge's detour
schedule from the kernel's argmin planes.

Serving loops re-plan the same cartridges constantly (the same checkpoint
restore, the same hot corpus slice), so hang a
:class:`repro_torch.core.SolveCache` on the library context
(``context=ExecutionContext(cache=SolveCache())``) and repeated identical
request multisets skip the solver entirely — only novel tapes reach a
backend.  The pre-context ``backend=``/``cache=`` keywords remain available
on every entry point as warning-emitting deprecation shims.

Everything is integer-exact and simulation-backed: every plan's
``total_cost`` equals the trajectory simulator's score of its detours
regardless of policy or backend.

For *online* serving the library also owns per-cartridge pending-request
queues (:class:`PendingQueue`, via :meth:`TapeLibrary.enqueue` /
:meth:`TapeLibrary.pending`): requests arriving over virtual time accumulate
per cartridge until an online serving loop turns a queue into an LTSP batch
for a drive.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from ..core import make_instance, service_times, solve_batch, virtual_lb
from ..core.context import ExecutionContext, resolve_context
from ..core.instance import Instance
from ..core.solver import SolveCache, SolveResult, solve

__all__ = [
    "TapeFile",
    "Tape",
    "TapeLibrary",
    "PendingQueue",
    "ReadPlan",
    "schedule_reads",
]

#: head repositioning penalty per U-turn, in position units (bytes here).
DEFAULT_U_TURN = 2_000_000


@dataclasses.dataclass(frozen=True)
class TapeFile:
    name: str
    left: int
    size: int

    @property
    def right(self) -> int:
        return self.left + self.size


class Tape:
    """One cartridge: files appended left-to-right (sequential writes)."""

    def __init__(self, tape_id: str, capacity: int, u_turn: int = DEFAULT_U_TURN):
        self.tape_id = tape_id
        self.capacity = capacity
        self.u_turn = u_turn
        self.files: dict[str, TapeFile] = {}
        self._cursor = 0

    @property
    def used(self) -> int:
        return self._cursor

    def append(self, name: str, size: int) -> TapeFile:
        if name in self.files:
            raise ValueError(f"duplicate file {name!r} on {self.tape_id}")
        if self._cursor + size > self.capacity:
            raise ValueError(f"tape {self.tape_id} full")
        f = TapeFile(name, self._cursor, size)
        self.files[name] = f
        self._cursor += size
        return f

    def instance(self, requests: dict[str, int]) -> tuple[Instance, list[str]]:
        """Build the LTSP instance for a request batch {name: multiplicity}."""
        names = sorted(requests, key=lambda n: self.files[n].left)
        fs = [self.files[n] for n in names]
        inst = make_instance(
            left=[f.left for f in fs],
            size=[f.size for f in fs],
            mult=[requests[n] for n in names],
            m=self.capacity,
            u_turn=self.u_turn,
        )
        return inst, names


class PendingQueue:
    """Ordered pending-request queue for one cartridge.

    Items must be mutually comparable (the online serving layer pushes
    requests that order by arrival time then request id); :meth:`pop`/:meth:`drain` return them oldest-first, so a
    preempted request re-enters ahead of later arrivals.
    """

    def __init__(self) -> None:
        self._heap: list = []

    def __len__(self) -> int:
        return len(self._heap)

    def __iter__(self):
        """Non-destructive iteration in arbitrary (heap) order.

        For order-insensitive scans only (e.g. the QoS layer's
        earliest-queued-deadline lookup); use :meth:`drain` for ordered
        removal.
        """
        return iter(self._heap)

    def push(self, item) -> None:
        heapq.heappush(self._heap, item)

    def peek(self):
        if not self._heap:
            raise IndexError("peek from an empty PendingQueue")
        return self._heap[0]

    def pop(self):
        if not self._heap:
            raise IndexError("pop from an empty PendingQueue")
        return heapq.heappop(self._heap)

    def drain(self) -> list:
        """Remove and return every pending item, oldest first."""
        out = [heapq.heappop(self._heap) for _ in range(len(self._heap))]
        return out


@dataclasses.dataclass
class ReadPlan:
    """Scheduled batch read for one tape."""

    tape_id: str
    policy: str
    order: list[str]  # file names in service order
    service_time: dict[str, int]  # per-file completion time
    total_cost: int  # sum over requests (the LTSP objective)
    mean_service: float  # total_cost / n requests
    virtual_lb: int
    detours: list[tuple[int, int]]
    backend: str = "python"


def _plan_from_result(
    tape: Tape, inst: Instance, names: list[str], res: SolveResult
) -> ReadPlan:
    t = service_times(inst, res.detours)
    order = [names[i] for i in np.argsort(t, kind="stable")]
    return ReadPlan(
        tape_id=tape.tape_id,
        policy=res.policy,
        order=order,
        service_time={names[i]: int(t[i]) for i in range(len(names))},
        total_cost=res.cost,
        mean_service=res.cost / inst.n,
        virtual_lb=virtual_lb(inst),
        detours=list(res.detours),
        backend=res.backend,
    )


def schedule_reads(
    tape: Tape,
    requests: dict[str, int],
    policy: str = "simpledp",
    backend: str | None = None,
    cache: SolveCache | None = None,
    *,
    context: ExecutionContext | None = None,
) -> ReadPlan:
    """Order a batch of reads on one tape with an LTSP policy.

    ``context`` selects backend/cache/numeric options;
    ``backend=``/``cache=`` are the deprecated spellings (see
    :mod:`repro_torch.core.context`).
    """
    ctx = resolve_context(context, backend=backend, cache=cache)
    inst, names = tape.instance(requests)
    res = solve(inst, policy=policy, context=ctx)
    return _plan_from_result(tape, inst, names, res)


class TapeLibrary:
    """A robotic library: many cartridges, simple fill placement.

    The library owns an :class:`~repro_torch.core.ExecutionContext` shared by every
    :meth:`schedule` call (hang a :class:`~repro_torch.core.SolveCache` on it so
    serving/restore loops never re-solve an identical tape).  The pre-context
    ``cache=`` constructor keyword is a warning-emitting deprecation shim.
    """

    def __init__(
        self,
        capacity_per_tape: int,
        u_turn: int = DEFAULT_U_TURN,
        cache: SolveCache | None = None,
        *,
        context: ExecutionContext | None = None,
    ):
        self.capacity = capacity_per_tape
        self.u_turn = u_turn
        self.tapes: list[Tape] = []
        self.location: dict[str, str] = {}  # file -> tape_id
        #: execution context shared by every schedule() call on this library.
        self.context = resolve_context(context, cache=cache)
        #: per-cartridge pending read requests (the online serving queues).
        self.queues: dict[str, PendingQueue] = {}

    @property
    def cache(self) -> SolveCache | None:
        """The context's solve memo (read-only convenience view)."""
        return self.context.cache

    def _tape_with_room(self, size: int) -> Tape:
        for t in self.tapes:
            if t.used + size <= t.capacity:
                return t
        t = Tape(f"TAPE{len(self.tapes):03d}", self.capacity, self.u_turn)
        self.tapes.append(t)
        return t

    def store(self, name: str, size: int) -> TapeFile:
        t = self._tape_with_room(size)
        f = t.append(name, size)
        self.location[name] = t.tape_id
        return f

    def tape_of(self, name: str) -> Tape:
        tid = self.location[name]
        return next(t for t in self.tapes if t.tape_id == tid)

    # -- online request queues (for the online serving loop) ------------------
    def enqueue(self, name: str, item) -> str:
        """Queue a pending read of ``name`` on its cartridge; returns tape id."""
        tid = self.location[name]
        self.pending(tid).push(item)
        return tid

    def pending(self, tape_id: str) -> PendingQueue:
        """The cartridge's pending-request queue (created on first use)."""
        return self.queues.setdefault(tape_id, PendingQueue())

    def schedule(
        self,
        requests: dict[str, int],
        policy: str = "simpledp",
        backend: str | None = None,
        cache: SolveCache | None = None,
        *,
        context: ExecutionContext | None = None,
    ) -> list[ReadPlan]:
        """Split a request batch per tape and schedule each.

        Cartridges are independent LTSP instances; device backends solve
        every cartridge's instance in a few size-bucketed launches
        (:func:`repro_torch.core.solve_batch`).  The library's own context applies
        unless the call passes ``context=`` (or the deprecated
        ``backend=``/``cache=`` keywords, which warn and fold over the
        library context).
        """
        ctx = resolve_context(
            context, backend=backend, cache=cache, default=self.context
        )
        per_tape: dict[str, dict[str, int]] = {}
        for name, k in requests.items():
            per_tape.setdefault(self.location[name], {})[name] = k
        tapes = {t.tape_id: t for t in self.tapes}
        triples = []
        for tid, reqs in sorted(per_tape.items()):
            inst, names = tapes[tid].instance(reqs)
            triples.append((tapes[tid], inst, names))
        results = solve_batch(
            [inst for _, inst, _ in triples], policy, context=ctx
        )
        return [
            _plan_from_result(tape, inst, names, res)
            for (tape, inst, names), res in zip(triples, results)
        ]
