"""Replica maps and placement strategies: *which shard* serves a request.

A federation (:class:`~repro_torch.fleet.server.FleetServer`) runs N per-library
shards; every arriving request names a logical file that may be stored — as
an exact replica — on several shards' tapes.  The router's job is the
placement decision: among the shards holding a replica, pick one,
deterministically.  This module supplies the three pieces:

* :class:`ReplicaMap` — the logical-file -> holder-shards catalogue,
  validated against each shard's :class:`~repro_torch.storage.tape.TapeLibrary`
  (a claimed replica must actually be stored there);
* :class:`FleetView` / :class:`ShardView` — the exact-int snapshot of every
  shard's state (queue depth, surviving drives, currently threaded tapes,
  mount cost model) a dynamic strategy decides against;
* :class:`PlacementStrategy` — the protocol, plus a registry
  (:func:`register_placement` / :func:`get_placement` /
  :func:`list_placements`) mirroring the solver/selector registries.

Registered strategies (:data:`PLACEMENTS`):

``single`` (the NoOp default)
    Requires a one-shard federation and routes everything to it — the
    degenerate federation whose timeline is pinned bit-identical to a
    standalone :class:`~repro_torch.serving.queue.OnlineTapeServer`.  This is the
    ``NoOpStrategy`` of the distributed-strategy idiom: the default path
    adds a layer without changing a single bit.
``static-hash``
    A stable content hash of the file name picks among the holder shards.
    Stateless and oblivious: no queue awareness, no health awareness — the
    baseline a dynamic router must beat, and the one that keeps hashing
    requests into a shard whose every drive is dead.
``least-loaded``
    The holder shard with the fewest queued requests (shard index breaking
    ties); shards with zero surviving drives sort last.
``replica-affinity``
    Exact-int affinity score per holder shard:
    ``(queue depth + 1) x drive-health penalty x remount cost``, where the
    health penalty is ``1 + (failed drives)`` and the remount factor is 1
    when the shard already has the file's tape threaded in a surviving
    drive, else ``1 + unmount + mount + load_seek`` from the shard's cost
    model.  Lowest score wins (shard index breaking ties); shards with zero
    surviving drives are only eligible when *every* holder is dead.  This
    is the router that steers work away from degraded shards.

Strategies are consulted with the *candidate* shard list already restricted
to replica holders, so every pick is feasible by construction.  All
arithmetic is exact integers; two runs with the same trace and federation
configuration route identically.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Mapping, Protocol, Sequence, runtime_checkable

from ..serving.drives import DriveCosts

__all__ = [
    "ReplicaMap",
    "ShardView",
    "FleetView",
    "PlacementStrategy",
    "PLACEMENTS",
    "SinglePlacement",
    "StaticHashPlacement",
    "LeastLoadedPlacement",
    "ReplicaAffinityPlacement",
    "register_placement",
    "get_placement",
    "list_placements",
]


# ---------------------------------------------------------------------------
# replica catalogue
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ReplicaMap:
    """Logical file -> sorted tuple of shard indices holding a replica.

    The map is pure data; :meth:`validate` checks it against the actual
    shard libraries (every claimed holder must store the file).  Replicas
    are *exact*: the same logical object written to several libraries,
    possibly on differently named tapes — the router rewrites the tape id
    per shard at dispatch.
    """

    holders_of: Mapping[str, tuple[int, ...]]

    def __post_init__(self) -> None:
        for name, holders in self.holders_of.items():
            if not holders:
                raise ValueError(f"file {name!r} has no replica holders")
            if list(holders) != sorted(set(holders)):
                raise ValueError(
                    f"holders of {name!r} must be sorted and unique, "
                    f"got {holders!r}"
                )
            if holders[0] < 0:
                raise ValueError(f"negative shard index for {name!r}")

    @classmethod
    def from_libraries(cls, libraries: Sequence) -> "ReplicaMap":
        """Derive the map from the shard libraries' stored files."""
        holders: dict[str, list[int]] = {}
        for i, lib in enumerate(libraries):
            for name in lib.location:
                holders.setdefault(name, []).append(i)
        return cls({name: tuple(sorted(h)) for name, h in sorted(holders.items())})

    def holders(self, name: str) -> tuple[int, ...]:
        """Shards holding a replica of ``name`` (raises on unknown files)."""
        try:
            return self.holders_of[name]
        except KeyError:
            raise ValueError(f"file {name!r} is not stored on any shard") from None

    def primary(self, name: str) -> int:
        """The lowest-indexed holder (the deterministic default origin)."""
        return self.holders(name)[0]

    def validate(self, libraries: Sequence) -> None:
        """Check every claimed replica is actually stored on its shard."""
        n = len(libraries)
        for name, holders in sorted(self.holders_of.items()):
            for shard in holders:
                if shard >= n:
                    raise ValueError(
                        f"replica of {name!r} claims shard {shard}, but the "
                        f"federation has only {n} shard(s)"
                    )
                if name not in libraries[shard].location:
                    raise ValueError(
                        f"replica map claims {name!r} on shard {shard}, but "
                        f"that library does not store it"
                    )

    def __len__(self) -> int:
        return len(self.holders_of)


# ---------------------------------------------------------------------------
# fleet state snapshot
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardView:
    """One shard's routing-relevant state at a virtual instant (exact ints)."""

    shard: int
    depth: int  # total queued requests across the shard's cartridges
    n_drives: int  # configured drives (dead ones included)
    n_alive: int  # surviving drives
    mounted: frozenset  # tape ids threaded in surviving drives
    costs: DriveCosts = dataclasses.field(default_factory=DriveCosts)

    @property
    def dead(self) -> bool:
        """No surviving drive: the shard can never dispatch again."""
        return self.n_alive == 0


@dataclasses.dataclass(frozen=True)
class FleetView:
    """Per-shard snapshots plus the candidate tapes for the routed file.

    ``tapes`` maps candidate shard index -> the tape id holding the file's
    replica *on that shard* (replicas may live on differently named tapes).
    """

    now: int
    shards: tuple[ShardView, ...]
    tapes: Mapping[int, str] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# strategy protocol + registry
# ---------------------------------------------------------------------------
@runtime_checkable
class PlacementStrategy(Protocol):
    """Routing decision: which holder shard serves this request.

    ``pick`` receives the file name, the candidate shard indices (the
    replica holders, sorted, never empty) and a :class:`FleetView`; it must
    return one of the candidates, deterministically.  ``dynamic`` declares
    whether the strategy reads runtime state: a static strategy (``False``)
    routes from the name alone, so the fleet may pre-partition the whole
    trace and run each shard's event loop standalone — byte-identical to N
    independent servers; a dynamic strategy forces the shared-clock
    interleaved loop.
    """

    name: str
    dynamic: bool

    def pick(
        self, name: str, candidates: tuple[int, ...], view: FleetView
    ) -> int:  # pragma: no cover - protocol signature
        ...


class SinglePlacement:
    """NoOp default: the one-shard federation, pinned bit-identical."""

    name = "single"
    dynamic = False

    def pick(self, name: str, candidates: tuple[int, ...], view: FleetView) -> int:
        return candidates[0]


def _stable_hash(name: str) -> int:
    """Process-stable content hash (``hash(str)`` is salted per process)."""
    return int.from_bytes(
        hashlib.blake2b(name.encode("utf-8"), digest_size=8).digest(), "big"
    )


class StaticHashPlacement:
    """Stable hash of the file name over the holder shards (oblivious)."""

    name = "static-hash"
    dynamic = False

    def pick(self, name: str, candidates: tuple[int, ...], view: FleetView) -> int:
        return candidates[_stable_hash(name) % len(candidates)]


class LeastLoadedPlacement:
    """Fewest queued requests among the holders (dead shards last)."""

    name = "least-loaded"
    dynamic = True

    def pick(self, name: str, candidates: tuple[int, ...], view: FleetView) -> int:
        return min(
            candidates,
            key=lambda i: (view.shards[i].dead, view.shards[i].depth, i),
        )


class ReplicaAffinityPlacement:
    """Queue depth x drive health x remount cost, lowest score wins."""

    name = "replica-affinity"
    dynamic = True

    def pick(self, name: str, candidates: tuple[int, ...], view: FleetView) -> int:
        def score(i: int) -> tuple[bool, int, int]:
            sv = view.shards[i]
            health = 1 + (sv.n_drives - sv.n_alive)
            tape = view.tapes.get(i)
            remount = (
                1
                if tape is not None and tape in sv.mounted
                else 1 + sv.costs.unmount + sv.costs.switch
            )
            return (sv.dead, (sv.depth + 1) * health * remount, i)

        return min(candidates, key=score)


#: registered placement strategies, by name (see the module docstring).
PLACEMENTS: dict[str, type] = {
    "single": SinglePlacement,
    "static-hash": StaticHashPlacement,
    "least-loaded": LeastLoadedPlacement,
    "replica-affinity": ReplicaAffinityPlacement,
}


def register_placement(cls: type, name: str | None = None) -> type:
    """Register a strategy class under ``name`` (default: ``cls.name``)."""
    key = name if name is not None else getattr(cls, "name", None)
    if not key or not isinstance(key, str):
        raise ValueError(f"placement strategy {cls!r} needs a string name")
    PLACEMENTS[key] = cls
    return cls


def get_placement(strategy: "str | PlacementStrategy") -> PlacementStrategy:
    """Name -> registered instance; a strategy object passes through."""
    if isinstance(strategy, str):
        if strategy not in PLACEMENTS:
            raise ValueError(
                f"unknown placement strategy {strategy!r}; choose from "
                f"{sorted(PLACEMENTS)}"
            )
        return PLACEMENTS[strategy]()
    if not isinstance(strategy, PlacementStrategy):
        raise TypeError(f"not a PlacementStrategy: {strategy!r}")
    return strategy


def list_placements() -> list[str]:
    """Registered strategy names, sorted."""
    return sorted(PLACEMENTS)
