"""The benchmark's own arithmetic of least time: peaks and the DP's work.

The least time of one table build is the larger of its operations over the
card's peak rate for the table type and its bytes over the HBM bandwidth.
It counts each tape's own shape, never a padded one: ``R = n_req`` window
ends and ``S = n + 1`` skip counts, the candidates the recurrence folds
under the policy's span, 7 operations per candidate and skip count (the
two table reads summed, the movement multiply and add, the U-turn multiply
and add, the compare), and the table cells ``a <= b`` written once, a value
(of the table type) and an argmin (int32) each.  So it reads the same work
whatever builds the tables, and a change to the padding or the tiling cannot
make it stale.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM, data sheet, dense, outside the tensor cores for the table
#: types: operations per second by table type, and HBM3 bytes per second.
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ITEM_BYTES = {"float64": 8, "float32": 4}
#: operations per candidate and skip count of the fold (see the module docstring)
OPS_PER_CANDIDATE = 7
#: bytes of one argmin entry (int32)
CHOICE_BYTES = 4


def policy_span(policy: str, n_req: int) -> int | None:
    """The detour-span limit of a DP policy: ``None`` for the exact DP,
    ``ceil(lam * ln n_req)`` (at least 1) for ``logdp<lam>``."""
    if policy == "dp":
        return None
    if policy.startswith("logdp"):
        lam = float(policy.removeprefix("logdp"))
        return max(1, math.ceil(lam * math.log(max(2, n_req))))
    raise ValueError(f"no span rule for policy {policy!r}")


def candidates(R: int, span: int | None) -> int:
    """Detour candidates over all windows ``a < b`` of an ``R``-file table:
    a window of width ``d = b - a`` folds ``c`` in ``max(a + 1, b - span)
    .. b``, that is ``min(d, span + 1)`` of them."""
    return sum((R - d) * (d if span is None else min(d, span + 1)) for d in range(1, R))


def table_work(n_req: int, n: int, span: int | None, type_name: str) -> tuple[int, int]:
    """``(operations, bytes)`` one table build of a tape needs."""
    S = n + 1
    ops = OPS_PER_CANDIDATE * candidates(n_req, span) * S
    cells = n_req * (n_req + 1) // 2 * S
    item = ITEM_BYTES[type_name]
    inputs = n_req * (3 * item + 4)  # left, right, n_left; multiplicities
    return ops, cells * (item + CHOICE_BYTES) + inputs


def least_seconds(n_req: int, n: int, span: int | None, type_name: str) -> float:
    """Least time of one table build on the card, in seconds."""
    ops, nbytes = table_work(n_req, n, span, type_name)
    return max(ops / PEAK_OPS_PER_S[type_name], nbytes / HBM_BYTES_PER_S)
