"""Warm-start state for incremental LTSP re-solves.

Serving loops re-solve *slightly perturbed* instances over and over: one
arrival bumps a multiplicity, a preemption drops the files already served,
an abort removes one request.  The DP table rows that only cover unchanged
files are still valid — this module captures them after a solve
(:class:`WarmState`) and maps them into the next solve so only invalidated
cells are re-evaluated.

Why transfer is sound (and bit-identical)
-----------------------------------------
``T[a, b, s]`` (see :mod:`repro_torch.core.dp`) is a function of *only* the
coordinate differences and multiplicities of requested files ``a..b``, the
U-turn penalty ``U``, the span restriction, and the combination
``w = s + n_l(a)``: every term of the recurrence — base, skip movement,
detour movement, U-turn charge — is a linear combination of coordinate
*differences* within ``[a, b]`` and of ``w`` plus multiplicity sums local to
``[a, b]``; the head-start position ``m`` never enters (only *VirtualLB*
does, which the caller recomputes from the new instance).  By induction the
same holds for every dependent cell, and the candidate scan order — skip
first, then ``c`` ascending, strict ``<`` to replace — is index-shifted but
order-preserved, so the argmin *choice* transfers too, ties included.

Concretely: align the new instance's requested files against the warm
instance's by exact ``(left, right, mult)`` equality (both are sorted with
strictly increasing ``left``, so a single merge walk suffices), then group
maximal runs that are contiguous *in both* instances into segments.  A cell
``(a, b, s)`` is transferable iff ``a`` and ``b`` fall in the same segment;
its warm twin is ``(a + off, b + off, s + delta)`` where ``off`` is the
segment's index offset and ``delta = n_l_new(a) - n_l_warm(a + off)`` — both
constant per segment because the multiplicities inside the segment match.
A warm choice ``c`` maps back as ``c - off`` (``-1`` = skip is unchanged).

Two store layouts back a :class:`WarmState`:

* :class:`DictStore` — the python DP's sparse ``memo``/``choice`` dicts,
  handed over by reference (no copy);
* :class:`DenseStore` — the device wavefront's dense value/argmin planes,
  kept in the kernel's gcd-rescaled int32 (or exact-f64) units together
  with the scale ``g``; lookups rescale to original units with python-int
  arithmetic, so no overflow guard is needed.  Dense cells outside the
  reachable envelope (``s`` too large for the padded skip axis) may hold
  clamped garbage, so :meth:`DenseStore.lookup` admits only cells whose
  entire dependency cone stays in range: ``s + sum(mult[a+1..b]) <= n``.

Reuse degrades gracefully: a warm state produced by a solve that itself
reused cells contains the reused cells' *values* but not their inner
structure, so a later solve that descends past them simply re-evaluates
(counted honestly in :class:`WarmStats`) — correctness never depends on
how much of the table transfers.
"""

from __future__ import annotations

import dataclasses

from .instance import Instance

__all__ = [
    "WarmState",
    "WarmStats",
    "DictStore",
    "DenseStore",
    "align_warm",
    "warm_from_instance",
]


@dataclasses.dataclass
class WarmStats:
    """Exact work accounting for one solve.

    ``cells_evaluated`` counts recurrence folds actually performed (for the
    dense device path: dense cells computed on device); ``cells_reused``
    counts cells installed or read from a warm state instead of being
    evaluated.  ``mode`` records which path ran: ``"cold"`` (no usable warm
    state), ``"warm"`` (some alignment existed — reuse may still be 0 if no
    aligned cell was needed), ``"cache"`` (memoised full solve, no DP work),
    or ``"unsupported"`` (policy/backend without warm support).
    """

    cells_evaluated: int = 0
    cells_reused: int = 0
    mode: str = "cold"


class DictStore:
    """Sparse store: the python DP's ``memo``/``choice`` dicts by reference."""

    kind = "dict"

    def __init__(
        self,
        memo: dict[tuple[int, int, int], int],
        choice: dict[tuple[int, int, int], int],
    ):
        self._memo = memo
        self._choice = choice

    def __len__(self) -> int:
        return len(self._memo)

    def lookup(self, a: int, b: int, s: int) -> tuple[int, int] | None:
        v = self._memo.get((a, b, s))
        if v is None:
            return None
        return v, self._choice[(a, b, s)]


class DenseStore:
    """Dense store: device value/argmin planes in gcd-rescaled units.

    ``table``/``choice`` are the ``[R_pad, R_pad, S_pad]`` planes of *one*
    instance (host numpy, int32 or f64); ``g`` is the
    :func:`repro_torch.kernels.ltsp_dp.ops.rescale_instance` scale, so the
    original-unit value is ``g * int(table[a, b, s])`` (python ints — exact
    at any magnitude).  ``prefix[i] = sum(mult[:i+1])`` bounds the admissible
    ``s`` per cell (see the module docstring).
    """

    kind = "dense"

    def __init__(self, table, choice, g: int, n: int, prefix: list[int]):
        self._table = table
        self._choice = choice
        self._g = g
        self._n = n
        self._prefix = prefix

    def __len__(self) -> int:
        return int(self._table.size)

    def lookup(self, a: int, b: int, s: int) -> tuple[int, int] | None:
        # admit only cells whose whole dependency cone is inside the
        # reachable envelope: the deepest skip chain reads the diagonal at
        # s + sum(mult[a+1..b]), which must stay <= n (< S_pad).
        if s + self._prefix[b] - self._prefix[a] > self._n:
            return None
        return self._g * int(self._table[a, b, s]), int(self._choice[a, b, s])


class WarmState:
    """Reusable DP state captured from one solve of one instance.

    The signature (``left``/``right``/``mult``/``u_turn``/``span``) pins the
    instance and restriction the store was computed under; ``store`` is a
    :class:`DictStore` or :class:`DenseStore`.  Warm states are
    backend-agnostic — both stores answer in original integer units, so a
    state captured from a device solve warms a python solve and vice versa.
    """

    __slots__ = ("left", "right", "mult", "u_turn", "span", "nl", "n", "store")

    def __init__(
        self,
        left: tuple[int, ...],
        right: tuple[int, ...],
        mult: tuple[int, ...],
        u_turn: int,
        span: int | None,
        store,
    ):
        self.left = left
        self.right = right
        self.mult = mult
        self.u_turn = u_turn
        self.span = span
        nl = [0]
        for xi in mult[:-1]:
            nl.append(nl[-1] + xi)
        self.nl = nl
        self.n = (nl[-1] + mult[-1]) if mult else 0
        self.store = store


def warm_from_instance(inst: Instance, span: int | None, store) -> WarmState:
    """Wrap a just-solved instance's store into a :class:`WarmState`."""
    return WarmState(
        left=tuple(inst.left.tolist()),
        right=tuple(inst.right.tolist()),
        mult=tuple(inst.mult.tolist()),
        u_turn=inst.u_turn,
        span=span,
        store=store,
    )


class _Alignment:
    """Per-file mapping from a new instance into a warm state's instance."""

    __slots__ = ("map_idx", "seg", "delta", "off")

    def __init__(
        self,
        map_idx: list[int],
        seg: list[int],
        delta: list[int],
        off: list[int],
    ):
        self.map_idx = map_idx  # warm index of new file i, or -1
        self.seg = seg  # segment id of new file i, or -1
        self.delta = delta  # per-segment skip-count shift (s_warm = s + delta)
        self.off = off  # per-segment index offset (warm = new + off)


def align_warm(warm: WarmState | None, inst: Instance, span: int | None):
    """Match ``inst``'s files against ``warm``'s; ``None`` if nothing maps.

    Requires equal U-turn penalty and span restriction (both enter the
    recurrence).  Files match on exact ``(left, right, mult)``; maximal runs
    contiguous in both instances become segments (see the module docstring).
    """
    if warm is None or warm.u_turn != inst.u_turn or warm.span != span:
        return None
    n_left = inst.left.tolist()
    n_right = inst.right.tolist()
    n_mult = inst.mult.tolist()
    w_left, w_right, w_mult = warm.left, warm.right, warm.mult
    R, W = len(n_left), len(w_left)
    map_idx = [-1] * R
    i = j = 0
    matched = 0
    while i < R and j < W:
        li, lj = n_left[i], w_left[j]
        if li == lj:
            if n_right[i] == w_right[j] and n_mult[i] == w_mult[j]:
                map_idx[i] = j
                matched += 1
            i += 1
            j += 1
        elif li < lj:
            i += 1
        else:
            j += 1
    if not matched:
        return None
    # segments: maximal runs matched contiguously in *both* instances
    seg = [-1] * R
    delta: list[int] = []
    off: list[int] = []
    nl_new = 0
    for i in range(R):
        if map_idx[i] >= 0:
            if i > 0 and seg[i - 1] >= 0 and map_idx[i - 1] == map_idx[i] - 1:
                seg[i] = seg[i - 1]
            else:
                seg[i] = len(delta)
                delta.append(nl_new - warm.nl[map_idx[i]])
                off.append(map_idx[i] - i)
        nl_new += n_mult[i]
    return _Alignment(map_idx, seg, delta, off)
