"""Kernel launch profiling: bucket shapes, padding waste, compile-vs-run.

The device path (:mod:`repro_torch.kernels.ltsp_dp.ops`) builds one bucketed
table per power-of-two ``(R, S, B)`` shape, and an uncaptured float64 table
alone at its tight shape.  A :class:`KernelProfile`
attached through ``ExecutionContext.obs`` records one
:class:`LaunchRecord` per launch:

* the padded shape that ran and the **exact** real-vs-padded DP cell counts
  (``padded = B_pad * R_pad * R_pad * S_pad``; ``real`` sums each
  instance's ``n_req^2 * (n + 1)`` table) — the padding-waste ratio the
  ROADMAP's ragged-grid item targets, as an exact fraction;
* ``cold`` — whether this profile has seen the launch's signature
  (shape bucket x dtype x plain-version flag x band layout) before: on the
  ``cuda`` backend a cold launch's wall time may include loading the kernel
  library.  (Scoped to the profile: a fresh profile on a warm process marks
  the first launch cold.)
* ``interpret`` — true when the plain torch version (``backend="torch"``)
  built the tables, the role the Pallas interpreter plays in the JAX
  package; the field keeps the JAX package's name so records compare.
* ``wall_ns`` — host wall time around the launch, closed after the results
  have come back to the host (so after a device synchronisation; on by
  default here: kernel profiling exists to measure the host clock, unlike
  the tracer).
"""

from __future__ import annotations

import dataclasses

__all__ = ["LaunchRecord", "KernelProfile"]


@dataclasses.dataclass(frozen=True)
class LaunchRecord:
    """One device launch: shape, exact cell accounting, timing."""

    n_instances: int
    R_pad: int
    S_pad: int
    B_pad: int
    real_cells: int
    padded_cells: int
    interpret: bool
    cold: bool
    wall_ns: int | None = None

    @property
    def waste(self) -> tuple[int, int]:
        """Padding waste as the exact fraction ``(wasted, padded)`` cells."""
        return (self.padded_cells - self.real_cells, self.padded_cells)


class KernelProfile:
    """Accumulates :class:`LaunchRecord` rows across a run."""

    def __init__(self, *, wall: bool = True):
        self.wall = bool(wall)
        self.launches: list[LaunchRecord] = []
        self._seen: set[tuple] = set()

    def record(
        self,
        *,
        signature: tuple,
        n_instances: int,
        R_pad: int,
        S_pad: int,
        B_pad: int,
        real_cells: int,
        interpret: bool,
        wall_ns: int | None = None,
    ) -> None:
        cold = signature not in self._seen
        self._seen.add(signature)
        self.launches.append(
            LaunchRecord(
                n_instances=n_instances,
                R_pad=R_pad,
                S_pad=S_pad,
                B_pad=B_pad,
                real_cells=real_cells,
                padded_cells=B_pad * R_pad * R_pad * S_pad,
                interpret=interpret,
                cold=cold,
                wall_ns=wall_ns,
            )
        )

    def summary(self) -> dict:
        """Exact totals: launch counts, cell accounting, waste fraction."""
        real = sum(r.real_cells for r in self.launches)
        padded = sum(r.padded_cells for r in self.launches)
        return {
            "n_launches": len(self.launches),
            "n_cold": sum(1 for r in self.launches if r.cold),
            "n_instances": sum(r.n_instances for r in self.launches),
            "real_cells": real,
            "padded_cells": padded,
            "wasted_cells": padded - real,
        }

    def __len__(self) -> int:
        return len(self.launches)
