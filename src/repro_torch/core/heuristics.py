"""Baseline LTSP algorithms: NODETOUR, GS, FGS, NFGS, LOGNFGS.

Adapted from Cardonha & Real [7] to account for U-turn penalties, following
the paper's Appendix B (including its three corrections to NFGS).  All return
detour lists over requested-file indices; the objective is always scored by
:func:`repro_torch.core.schedule.evaluate_detours`.
"""

from __future__ import annotations

import math

import numpy as np

from .instance import Instance

__all__ = [
    "no_detour",
    "gs",
    "fgs",
    "nfgs",
    "lognfgs",
]


def no_detour(inst: Instance) -> list[tuple[int, int]]:
    """Sweep to the leftmost request, then one left-to-right pass."""
    return []


def gs(inst: Instance) -> list[tuple[int, int]]:
    """Greedy Scheduling: one atomic detour per requested file.

    3-approximation when U == 0 [6].
    """
    return [(f, f) for f in range(inst.n_req)]


def fgs(inst: Instance) -> list[tuple[int, int]]:
    """Filtered GS: drop detours that Lemma 3 (Eq. 5) proves detrimental.

    Removing ``(f, f)`` from a single-file detour list ``L`` strictly helps iff

      2 x(f) (l(f) + sum_{g<f, g in L} (s(g)+U))
        < 2 (s(f)+U) (sum_{g<f} x(g) + sum_{g>f, g not in L} x(g))

    The filter is re-run ``n_req`` times since each removal can make another
    detour detrimental.  O(n_req^2).
    """
    R = inst.n_req
    left = inst.left.tolist()
    size = (inst.right - inst.left).tolist()
    x = inst.mult.tolist()
    U = inst.u_turn

    in_l = [True] * R
    nl_all = inst.n_left().tolist()  # sum_{g<f} x(g), independent of L

    for _ in range(R):
        changed = False
        # suffix of requests on skipped files (g > f, g not in L) from the
        # state of L at the start of the pass; removals during the pass only
        # happen at positions <= f so the suffix stays exact (see paper B.3).
        skip_suffix = [0] * (R + 1)
        for g in range(R - 1, -1, -1):
            skip_suffix[g] = skip_suffix[g + 1] + (0 if in_l[g] else x[g])
        run_det = 0  # sum_{g<f, g in L} (s(g)+U), maintained along the sweep
        for f in range(R):
            if in_l[f]:
                lhs = 2 * x[f] * (left[f] + run_det)
                rhs = 2 * (size[f] + U) * (nl_all[f] + skip_suffix[f + 1])
                if lhs < rhs:
                    in_l[f] = False
                    changed = True
            if in_l[f]:
                run_det += size[f] + U
        if not changed:
            break
    return [(f, f) for f in range(R) if in_l[f]]


def _delta(
    inst: Instance,
    covered: np.ndarray,
    det_left_len: np.ndarray,
    a: int,
    bs: np.ndarray,
) -> np.ndarray:
    """Paper Definition 1, vectorised over candidate right endpoints ``bs``.

    Delta(L,(a,b)) = 2 (r(b)-l(a)+U) (sum_{f<a} x(f) + sum_{f>b, f not in L} x(f))
                   - 2 sum_{f in [a,b], f not in L} x(f)
                       * (l(a) + sum_{(f',g') in L, f'<a} (r(g')-l(f')+U))

    ``covered[f]``       - f lies inside some detour of L.
    ``det_left_len[a]``  - sum of (r(g')-l(f')+U) over detours starting left
                           of a (precomputed prefix).
    """
    x = inst.mult
    nl_all = inst.n_left()
    # suffix of uncovered requests strictly right of b
    unc = np.where(covered, 0, x)
    unc_suffix = np.concatenate([np.cumsum(unc[::-1])[::-1], [0]])
    pending = nl_all[a] + unc_suffix[bs + 1]
    unc_prefix = np.concatenate([[0], np.cumsum(unc)])
    in_ab = unc_prefix[bs + 1] - unc_prefix[a]
    term1 = 2 * (inst.right[bs] - inst.left[a] + inst.u_turn) * pending
    term2 = 2 * in_ab * (inst.left[a] + det_left_len[a])
    return term1 - term2


def _nfgs_impl(inst: Instance, max_span: int | None) -> list[tuple[int, int]]:
    """NFGS / LOGNFGS with the paper's three corrections (Appendix B.4):

    * ``argmin`` ranges over ``f' >= f`` (single-file detours can be kept),
    * a single-file detour lying inside an earlier multi-file detour is never
      removed (the Delta flaw would otherwise force its removal),
    * Delta uses ``f' < a`` in the left-detour-length sum.
    """
    R = inst.n_req
    res: dict[int, int] = {f: f for f, _ in fgs(inst)}  # start from FGS
    rightest = -1

    for f in range(R):
        was_a_detour = f in res and res[f] == f
        # temp = res minus the atomic detour (f, f)
        temp = dict(res)
        if was_a_detour:
            del temp[f]

        # coverage + prefix of detour lengths for temp
        covered = np.zeros(R, dtype=bool)
        starts = np.zeros(R, dtype=np.int64)  # detour length bucketed at start
        for a0, b0 in temp.items():
            covered[a0 : b0 + 1] = True
            starts[a0] += inst.right[b0] - inst.left[a0] + inst.u_turn
        # det_left_len[a] = sum of lengths of detours starting strictly left of a
        det_left_len = np.concatenate([[0], np.cumsum(starts)[:-1]])

        hi = R - 1 if max_span is None else min(R - 1, f + max_span)
        bs = np.arange(f, hi + 1)
        deltas = _delta(inst, covered, det_left_len, f, bs)
        k = int(np.argmin(deltas))
        f_star, d_star = int(bs[k]), int(deltas[k])

        if d_star >= 0 and was_a_detour and rightest > f:
            # inside a longer detour: Delta cannot be negative there, keep the
            # atomic detour rather than losing it (paper's correction)
            res = temp
            res[f] = f
            continue
        res = temp
        if d_star < 0:
            res[f] = f_star
            rightest = max(rightest, f_star)
    return sorted(res.items())


def nfgs(inst: Instance) -> list[tuple[int, int]]:
    """Non-atomic FGS: greedily replace atomic detours by multi-file ones."""
    return _nfgs_impl(inst, None)


def lognfgs(inst: Instance, lam: float = 5.0) -> list[tuple[int, int]]:
    """NFGS restricted to detour spans of at most ``lam * ln(n_req)`` files."""
    span = max(1, math.ceil(lam * math.log(max(2, inst.n_req))))
    return _nfgs_impl(inst, span)
