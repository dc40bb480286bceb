"""The paper's exact **DP** algorithm for LTSP, plus LOGDP and SIMPLEDP.

``T[a, b, n_skip]`` (paper §4.3) is the impact, relative to *VirtualLB*, of
the head movement between the first time it reaches ``r(b)`` and the first
time it reaches ``r(b)`` again after having read ``a``, given

  1. a detour ``(a, f)`` exists for some ``f >= b``,
  2. no detour ``(f1, f2)`` with ``a < f1 < b < f2`` exists,
  3. exactly ``n_skip`` requests are skipped when the head first reaches
     ``r(b)``.

Recurrence (files are requested-file indices, ``left(b) = b-1``)::

  T[b, b, s]    = 2 s(b) (s + n_l(b))
  skip(a,b,s)   = T[a, b-1, s + x(b)] + 2 (r(b)-r(b-1)) (s + n_l(a))
                  + 2 (l(b)-r(b-1)) x(b)
  detour_c(...) = T[a, c-1, s] + T[c, b, s] + 2 (r(b)-r(c-1)) (s + n_l(a))
                  + 2 U (s + n_l(c))
  T[a, b, s]    = min(skip, min_{a < c <= b} detour_c)

and ``OPT = T[0, R-1, 0] + VirtualLB``.

Exact Python-int arithmetic over reachable cells only.  The evaluation is
**iterative**: an explicit post-order work stack expands a cell's
dependencies, then folds them once every one is memoised, so arbitrarily
large instances run without touching the interpreter recursion limit (the
seed implementation had to raise it ~10x n_req).  Cell values
and tie-breaking are bit-identical to the recursive formulation: ``skip``
wins ties, and among detours the smallest ``c`` achieving the minimum wins.

LOGDP is the same recursion with ``c`` restricted to ``b - c <= span`` where
``span = ceil(lambda * ln n_req)``; SIMPLEDP forbids intertwined detours which
collapses the first index to ``f_1`` (2-dimensional table).
"""

from __future__ import annotations

import math

from .instance import Instance, virtual_lb
from .warm import DictStore, WarmState, WarmStats, align_warm, warm_from_instance

__all__ = [
    "dp_schedule",
    "dp_schedule_warm",
    "logdp_schedule",
    "simpledp_schedule",
    "dp_value",
    "logdp_span",
]


def dp_schedule(
    inst: Instance, span: int | None = None
) -> tuple[int, list[tuple[int, int]]]:
    """Optimal LTSP schedule via the paper's DP.

    Returns ``(opt_cost, detours)`` where ``opt_cost`` includes *VirtualLB*
    and ``detours`` is the list of detours realising it (the implicit final
    global pass is not listed).  ``span`` restricts detour spans (LOGDP).
    """
    cost, detours, _, _ = dp_schedule_warm(inst, span=span)
    return cost, detours


def dp_schedule_warm(
    inst: Instance,
    span: int | None = None,
    warm: WarmState | None = None,
) -> tuple[int, list[tuple[int, int]], WarmState, WarmStats]:
    """:func:`dp_schedule` with warm-start reuse and exact work counters.

    ``warm`` is a :class:`~repro_torch.core.warm.WarmState` from a previous solve
    of a *related* instance (same cartridge, perturbed request multiset).
    Cells covered by an aligned segment (see :mod:`repro_torch.core.warm`) are
    installed from the warm store instead of being folded; everything else —
    including the whole table when no alignment exists — evaluates exactly
    as the cold DP does, so ``(cost, detours)`` is bit-identical to
    :func:`dp_schedule` by construction *and* asserted differentially in the
    tests.  Returns ``(cost, detours, new_warm, stats)`` where ``new_warm``
    wraps this solve's memo for the next tick (handed over by reference, no
    copy) and ``stats`` counts recurrence folds vs. warm transfers.
    """
    R = inst.n_req
    left = inst.left.tolist()
    right = inst.right.tolist()
    x = inst.mult.tolist()
    nl = inst.n_left().tolist()
    U = inst.u_turn
    size = [r - l for l, r in zip(left, right)]

    memo: dict[tuple[int, int, int], int] = {}
    choice: dict[tuple[int, int, int], int] = {}  # -1 = skip, else c
    stats = WarmStats(mode="cold")
    al = align_warm(warm, inst, span)
    if al is not None:
        stats.mode = "warm"
        w_store, w_seg, w_map, w_delta, w_off = (
            warm.store, al.seg, al.map_idx, al.delta, al.off,
        )

    def base(b: int, s: int) -> int:
        return 2 * size[b] * (s + nl[b])

    def try_warm(a: int, b: int, s: int) -> bool:
        """Install ``(a, b, s)`` from the warm store if an aligned segment
        covers it (value and index-shifted choice; see repro_torch.core.warm)."""
        sa = w_seg[a]
        if sa < 0 or sa != w_seg[b]:
            return False
        sw = s + w_delta[sa]
        if sw < 0:
            return False
        hit = w_store.lookup(w_map[a], w_map[b], sw)
        if hit is None:
            return False
        v, cw = hit
        memo[(a, b, s)] = v
        choice[(a, b, s)] = cw if cw < 0 else cw - w_off[sa]
        stats.cells_reused += 1
        return True

    def deps(a: int, b: int, s: int):
        """Non-base cells the recurrence for ``(a, b, s)`` reads."""
        out = []
        if a < b - 1:
            out.append((a, b - 1, s + x[b]))  # skip
        lo = a + 1 if span is None else max(a + 1, b - span)
        for c in range(lo, b + 1):
            if a < c - 1:
                out.append((a, c - 1, s))
            if c < b:
                out.append((c, b, s))
        return out

    def value(a: int, b: int, s: int) -> tuple[int, int]:
        """Fold the recurrence assuming every dependency is memoised."""
        t_skip = base(b - 1, s + x[b]) if a == b - 1 else memo[(a, b - 1, s + x[b])]
        best = (
            t_skip
            + 2 * (right[b] - right[b - 1]) * (s + nl[a])
            + 2 * (left[b] - right[b - 1]) * x[b]
        )
        arg = -1
        lo = a + 1 if span is None else max(a + 1, b - span)
        snla = s + nl[a]
        for c in range(lo, b + 1):
            t_left = base(a, s) if c - 1 == a else memo[(a, c - 1, s)]
            t_right = base(b, s) if c == b else memo[(c, b, s)]
            v = (
                t_left
                + t_right
                + 2 * (right[b] - right[c - 1]) * snla
                + 2 * U * (s + nl[c])
            )
            if v < best:
                best, arg = v, c
        return best, arg

    def run(cell: tuple[int, int, int]) -> None:
        """Evaluate ``cell`` (and everything it transitively needs).

        Post-order over the dependency DAG with an explicit stack: a cell is
        pushed unexpanded, re-pushed expanded together with its unresolved
        dependencies, and folded when seen expanded (all deps then memoised).
        A warm transfer at first encounter short-circuits the expansion —
        the reused value stands in for the whole subtree below it.
        """
        stack: list[tuple[int, int, int, bool]] = [(*cell, False)]
        while stack:
            a, b, s, expanded = stack.pop()
            if (a, b, s) in memo:
                continue
            if expanded:
                memo[(a, b, s)], choice[(a, b, s)] = value(a, b, s)
                stats.cells_evaluated += 1
                continue
            if al is not None and try_warm(a, b, s):
                continue
            stack.append((a, b, s, True))
            for dep in deps(a, b, s):
                if dep not in memo:
                    stack.append((*dep, False))

    root = (0, R - 1, 0)
    if R == 1:
        opt_rel = base(0, 0)
    else:
        run(root)
        opt_rel = memo[root]

    opt = opt_rel + virtual_lb(inst)

    # -- traceback: pre-order replay of the recorded choices ------------------
    # A warm-transferred cell carries its choice but not its inner structure;
    # when the optimal path descends past one, run() lazily resolves the
    # missing cell (warm store first, recurrence otherwise) — exact either
    # way, and any extra folds are counted in stats.cells_evaluated.
    detours: list[tuple[int, int]] = []
    work: list[tuple[int, int, int]] = [root]
    while work:
        a, b, s = work.pop()
        while a < b:
            c = choice.get((a, b, s))
            if c is None:
                run((a, b, s))
                c = choice[(a, b, s)]
            if c == -1:  # skip b
                s += x[b]
                b -= 1
                continue
            detours.append((c, b))
            # detour (c, b): descend into its inner structure first, then
            # continue with T[a, c-1, s] (pushed for later — preserves the
            # recursive emission order).
            work.append((a, c - 1, s))
            a = c
        # a == b: base cell, single-file handling folded into parent detour
    new_warm = warm_from_instance(inst, span, DictStore(memo, choice))
    return opt, detours, new_warm, stats


def dp_value(inst: Instance, span: int | None = None) -> int:
    """Optimal cost only (convenience)."""
    return dp_schedule(inst, span=span)[0]


def logdp_span(n_req: int, lam: float) -> int:
    """LOGDP detour-span limit: ``ceil(lambda * ln n_req)`` (>= 1)."""
    return max(1, math.ceil(lam * math.log(max(2, n_req))))


def logdp_schedule(inst: Instance, lam: float = 1.0) -> tuple[int, list[tuple[int, int]]]:
    """LOGDP(lambda): DP restricted to detours spanning <= lam*ln(n_req) files."""
    return dp_schedule(inst, span=logdp_span(inst.n_req, lam))


def simpledp_schedule(inst: Instance) -> tuple[int, list[tuple[int, int]]]:
    """SIMPLEDP: DP restricted to disjoint (non-intertwined) detours.

    The first DP index is always the leftmost requested file, so the table is
    two-dimensional, and ``detour_c`` charges the whole detour ``(c, b)``
    directly (no recursive inner structure)::

      detour_c(b,s) = T[c-1, s] + 2 (r(b)-r(c-1)) s
                      + 2 (U + r(b)-l(c)) (s + n_l(c))
                      + sum_{c < f <= b} 2 (l(f)-l(c)) x(f)

    Evaluated iteratively like :func:`dp_schedule` (explicit work stack over
    reachable ``(b, s)`` cells, exact Python ints).
    """
    R = inst.n_req
    left = inst.left.tolist()
    right = inst.right.tolist()
    x = inst.mult.tolist()
    nl = inst.n_left().tolist()
    U = inst.u_turn
    size = [r - l for l, r in zip(left, right)]

    # prefix sums for the in-detour service cost sum (Python ints: exact,
    # immune to int64 overflow on real tape coordinates ~2e13)
    X = [0]
    WL = [0]
    for li, xi in zip(left, x):
        X.append(X[-1] + xi)
        WL.append(WL[-1] + li * xi)

    def in_detour_cost(c: int, b: int) -> int:
        # sum_{c < f <= b} 2 (l(f) - l(c)) x(f)
        return 2 * ((WL[b + 1] - WL[c + 1]) - left[c] * (X[b + 1] - X[c + 1]))

    memo: dict[tuple[int, int], int] = {}
    choice: dict[tuple[int, int], int] = {}

    def base0(s: int) -> int:
        return 2 * size[0] * (s + nl[0])

    def value(b: int, s: int) -> tuple[int, int]:
        t_skip = base0(s + x[b]) if b == 1 else memo[(b - 1, s + x[b])]
        best = (
            t_skip
            + 2 * (right[b] - right[b - 1]) * s  # n_l(a=0) == 0
            + 2 * (left[b] - right[b - 1]) * x[b]
        )
        arg = -1
        for c in range(1, b + 1):
            t_left = base0(s) if c == 1 else memo[(c - 1, s)]
            v = (
                t_left
                + 2 * (right[b] - right[c - 1]) * s
                + 2 * (U + right[b] - left[c]) * (s + nl[c])
                + in_detour_cost(c, b)
            )
            if v < best:
                best, arg = v, c
        return best, arg

    if R == 1:
        opt_rel = base0(0)
    else:
        stack: list[tuple[int, int, bool]] = [(R - 1, 0, False)]
        while stack:
            b, s, expanded = stack.pop()
            if (b, s) in memo:
                continue
            if expanded:
                memo[(b, s)], choice[(b, s)] = value(b, s)
                continue
            stack.append((b, s, True))
            if b - 1 > 0 and (b - 1, s + x[b]) not in memo:
                stack.append((b - 1, s + x[b], False))
            for c in range(2, b + 1):
                if (c - 1, s) not in memo:
                    stack.append((c - 1, s, False))
        opt_rel = memo[(R - 1, 0)]

    opt = opt_rel + virtual_lb(inst)

    detours: list[tuple[int, int]] = []
    b, s = R - 1, 0
    while b > 0:
        c = choice[(b, s)]
        if c == -1:
            s += x[b]
            b -= 1
        else:
            detours.append((c, b))
            b = c - 1
    return opt, detours
