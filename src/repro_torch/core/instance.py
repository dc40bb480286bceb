"""LTSP problem instances.

Model (paper §3): a linear tape of length ``m`` holds ``n_f`` disjoint files
read left-to-right.  A subset of ``n_req`` files is requested, file ``f`` with
multiplicity ``x(f) >= 1`` (``n`` total requests).  The head starts at the
right end of the tape, moves at unit speed, and pays a penalty ``U`` per
U-turn.  A request on ``f`` is served the first time ``f`` has been traversed
left-to-right.  Objective: minimise the sum of service times.

All coordinates are integers so every algorithm in :mod:`repro_torch.core` is exact
(int64 / Python ints, no float rounding).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["Instance", "make_instance", "virtual_lb"]


@dataclasses.dataclass(frozen=True)
class Instance:
    """An LTSP instance restricted to the requested files.

    Only requested files matter for scheduling decisions; unrequested files
    only contribute dead space between requested ones, which is captured by
    the ``left``/``right`` coordinates.  We therefore store one entry per
    *requested* file, left-to-right.

    Attributes
    ----------
    left:   ``left[i]``  = position of the left edge of requested file ``i``.
    right:  ``right[i]`` = position of the right edge (= left + size).
    mult:   ``mult[i]``  = number of requests x(f_i)  (>= 1).
    m:      total tape length (head starts at position ``m``).
    u_turn: penalty U added per U-turn of the head.
    """

    left: np.ndarray  # int64 [R]
    right: np.ndarray  # int64 [R]
    mult: np.ndarray  # int64 [R]
    m: int
    u_turn: int

    # ---- derived quantities -------------------------------------------------
    @property
    def n_req(self) -> int:
        """Number of distinct requested files (R)."""
        return int(self.left.shape[0])

    @property
    def n(self) -> int:
        """Total number of requests (with multiplicity)."""
        return int(self.mult.sum())

    @property
    def size(self) -> np.ndarray:
        return self.right - self.left

    def n_left(self) -> np.ndarray:
        """``n_left[i]`` = number of requests on files strictly left of i."""
        c = np.zeros(self.n_req, dtype=np.int64)
        c[1:] = np.cumsum(self.mult)[:-1]
        return c

    def validate(self) -> None:
        assert self.left.dtype == np.int64 and self.right.dtype == np.int64
        assert self.n_req >= 1
        assert (self.mult >= 1).all(), "every requested file needs >= 1 request"
        assert (self.right > self.left).all(), "files have positive size"
        # disjoint, sorted left-to-right
        assert (self.left[1:] >= self.right[:-1]).all(), "files must be disjoint/sorted"
        assert self.right[-1] <= self.m, "files must fit on the tape"
        assert self.left[0] >= 0
        assert self.u_turn >= 0


def make_instance(
    left: Sequence[int],
    size: Sequence[int],
    mult: Sequence[int],
    m: int | None = None,
    u_turn: int = 0,
) -> Instance:
    """Build and validate an :class:`Instance` from plain sequences."""
    left_a = np.asarray(left, dtype=np.int64)
    size_a = np.asarray(size, dtype=np.int64)
    mult_a = np.asarray(mult, dtype=np.int64)
    order = np.argsort(left_a, kind="stable")
    left_a, size_a, mult_a = left_a[order], size_a[order], mult_a[order]
    right_a = left_a + size_a
    if m is None:
        m = int(right_a[-1])
    inst = Instance(left=left_a, right=right_a, mult=mult_a, m=int(m), u_turn=int(u_turn))
    inst.validate()
    return inst


def virtual_lb(inst: Instance) -> int:
    """Paper's *VirtualLB*: each request served by its own virtual head.

    ``VirtualLB = sum_f x(f) * (m - l(f) + s(f) + U)``: the head travels from
    the right end (position m) to ``l(f)`` (one U-turn), then reads ``f``.
    """
    # Python-int accumulation: exact for real tape coordinates (~2e13) times
    # large multiplicities, where int64 products could overflow.
    total = 0
    for li, ri, xi in zip(inst.left.tolist(), inst.right.tolist(), inst.mult.tolist()):
        total += xi * (inst.m - li + (ri - li) + inst.u_turn)
    return total
