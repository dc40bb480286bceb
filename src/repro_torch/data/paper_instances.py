"""The paper's adversarial instance families (approximation-ratio witnesses).

* :func:`gs_worst_case`       — GS approaches its factor 3 (U=0): a small,
  heavily requested file on the left of one large file spanning the tape.
* :func:`simpledp_worst_case` — Lemma 2's family where forbidding intertwined
  detours costs a factor approaching 5/3.
* :func:`logdp_worst_case`    — §4.5's family where bounding detour spans
  keeps LOGDP at ratio ~3 (U = 0).
"""

from __future__ import annotations

from ..core.instance import Instance, make_instance

__all__ = ["gs_worst_case", "simpledp_worst_case", "logdp_worst_case"]


def gs_worst_case(big: int = 10_000, requests: int = 10_000) -> Instance:
    """f1: unit file with many requests; f2: huge file, single request."""
    return make_instance(
        left=[0, 1],
        size=[1, big],
        mult=[requests, 1],
        m=1 + big,
        u_turn=0,
    )


def simpledp_worst_case(z: int = 50) -> Instance:
    """Lemma 2 family: OPT uses intertwined detours, SIMPLEDP cannot.

    f1 far left (forces detours); f2, f3 urgent unit files separated so that
    r(f4) - l(f2) = 2z; f4 large (size z), less urgent, contiguous to f3.
    OPT ~ 3 z^3 via detours [(f3,f3), (f2,f4)]; any non-intertwined solution
    costs >= ~5 z^3.
    """
    l2 = 3 * z * z
    return make_instance(
        left=[0, l2, l2 + z - 1, l2 + z],
        size=[1, 1, 1, z],
        mult=[1, z * z, z * z, z],
        m=l2 + 2 * z,
        u_turn=0,
    )


def logdp_worst_case(z: int = 40) -> Instance:
    """§4.5 family: z requested files; one far-left non-urgent unit file, then
    z-1 contiguous files starting at 2 z^3 — unit sized except the last of
    size z^2; x(f2) = z^2 (urgent), x(f_z) = z, others 1."""
    left = [0]
    size = [1]
    mult = [1]
    for i in range(z - 1):
        left.append(2 * z**3 + i)
        size.append(1 if i < z - 2 else z * z)
        mult.append(1)
    mult[1] = z * z  # f2 urgent
    mult[-1] = z  # f_z less urgent
    m = left[-1] + size[-1]
    return make_instance(left=left, size=size, mult=mult, m=m, u_turn=0)
