"""Host-side drivers for the LTSP wavefront: adapters, rescaling, traceback,
and a size-bucketed batch planner.

The device path is a **complete solver**: :func:`ltsp_dp_tables` (the CUDA
wavefront, see :mod:`.ltsp_dp`) returns the value table *and* per-cell argmin
planes; :func:`traceback_detours` replays the argmin planes on the host to
reconstruct the optimal detour list, exactly like the Python DP's traceback.

Two backends build the tables: ``"cuda"`` launches the hand-written kernel
and needs a CUDA ``device``; ``"torch"`` runs its plain version
(:mod:`.ref`) on any ``device``.  Both give bit-identical planes.  Every
entry point takes ``backend=`` and ``device=`` (default ``"cuda"`` for both).

Three numeric modes:

* ``int32`` (solver default) — bit-exact while every table value fits in
  int32.  Before the :func:`_check_int32_safe` magnitude guard runs,
  :func:`rescale_instance` shifts each instance to its leftmost requested
  byte and divides all coordinates (and the U-turn penalty) by their gcd —
  every DP term is a coordinate *difference*, so the whole table scales by
  exactly ``1/g`` and the argmin structure (ties included) is untouched.
  Real cartridge layouts share the tape's block granularity, so byte
  coordinates far beyond int32 rescale into range; the guard rejects only
  genuinely coprime byte-scale layouts.
* ``float64`` (``numeric_policy="f64"`` fallback, exact for values < 2**53) —
  instances the int32 guard rejects are re-solved through the same wavefront
  in float64, each in its own tight launch, on the same backend (FP64 is
  native on the card).  Integer table values below 2**53 are exactly
  representable, so within :func:`_check_f64_safe`'s bound the result is
  still bit-identical to the python DP; beyond it the guard raises either
  way.  Selected via ``ExecutionContext.numeric_policy``; the default
  ``"strict"`` keeps the raise.  At the paper's IN2P3 scale every tape fails
  the int32 guard, so this is the path real cartridges take.
* ``float32`` (oracle-comparison default, exact for values < 2**24) — used by
  the value-only :func:`ltsp_dp_table`/:func:`ltsp_opt` wrappers.

``disjoint=True`` routes SIMPLEDP through the same kernel: the candidate band
is clipped to root-level cells (no detour may start inside another), which
collapses the 3-D table to SIMPLEDP's 2-D recursion — same mechanism as the
LOGDP ``span`` clip, bit-identical to :func:`repro.core.dp.simpledp_schedule`
(cost *and* traceback).

Batching and the bucket planner
-------------------------------
Instances are right-padded with zero-width, zero-multiplicity phantom files at
the rightmost coordinate.  A phantom file's ``skip`` transition is free and
never loses to a detour (detours only add nonnegative terms there, and skip
wins ties), so neither the root value nor the traceback changes — several
tapes' instances solve in one device launch.

A single launch must share one ``(B, R, S)`` shape, so the seed driver padded
*every* instance to the global ``(R_max, S_max)`` — maximally wasteful on the
heterogeneous cartridge batches the IN2P3 logs actually produce.
:func:`plan_buckets` instead groups instances into a small set of shape
buckets and :func:`ltsp_solve_batch` launches one tight wavefront per bucket.

Bucket-rounding policy (applies to every padded dimension):

* ``R`` (requested files) rounds up to the next power of two;
* ``S`` (skip counts, ``n + 1``) rounds up to the next power-of-two multiple
  of 128: 128, 256, 512, … (the JAX package's rounding, kept identical
  because ``len(DenseStore)`` becomes ``WarmStats.cells_evaluated``);
* ``B`` (instances per launch) rounds up to the next power of two, padding
  with all-phantom rows that are never traced back.

Powers-of-two rounding bounds the set of distinct launch shapes
logarithmically; within a bucket, padding waste is at most 2x per dimension
instead of unbounded.
``ltsp_solve_batch([])`` returns ``[]`` and single-instance batches skip the
planner entirely (one tight launch, no grouping pass).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ...core.instance import Instance, virtual_lb
from ...core.warm import DenseStore, WarmState, WarmStats, align_warm, warm_from_instance
from .ltsp_dp import DEFAULT_CAND_TILE, ltsp_dp_tables
from .ref import ltsp_dp_tables_ref

__all__ = [
    "prepare_arrays",
    "prepare_batch",
    "plan_buckets",
    "bucket_shape",
    "rescale_instance",
    "traceback_detours",
    "ltsp_dp_table",
    "ltsp_opt",
    "ltsp_opt_instance",
    "ltsp_solve_instance",
    "ltsp_solve_batch",
    "ltsp_solve_instance_warm",
    "ltsp_solve_batch_warm",
]


def _pad_s(S: int) -> int:
    return int(math.ceil(S / 128) * 128)


def _pow2(v: int) -> int:
    """Smallest power of two >= v (v >= 1)."""
    return 1 << max(0, int(v) - 1).bit_length()


def bucket_shape(inst: Instance) -> tuple[int, int]:
    """``(R_pad, S_pad)`` shape bucket for one instance.

    See the module docstring for the rounding policy: ``R`` to the next power
    of two, ``S = n + 1`` to the next power-of-two multiple of 128.
    """
    return _pow2(inst.n_req), 128 * _pow2(-(-(inst.n + 1) // 128))


def plan_buckets(instances: list[Instance]) -> dict[tuple[int, int], list[int]]:
    """Group instance indices by shape bucket (insertion-ordered)."""
    buckets: dict[tuple[int, int], list[int]] = {}
    for i, inst in enumerate(instances):
        buckets.setdefault(bucket_shape(inst), []).append(i)
    return buckets


def _tensor(values, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy values → tensor; the type conversion happens in numpy, as it
    does in the JAX package, so both round identically."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return torch.from_numpy(np.asarray(values).astype(np_dtype)).to(device)


def _check_backend(backend: str, device) -> None:
    """``"cuda"`` needs a CUDA device; no backend silently changes device."""
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown device backend {backend!r}; use 'cuda' or 'torch'")
    dev = torch.device(device)
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError(
            f"backend='cuda' launches the CUDA kernel and needs a CUDA device, "
            f"got device={str(device)!r} (backend='torch' runs the plain version "
            f"on any device)"
        )
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch sees no CUDA device"
        )


def prepare_arrays(
    inst: Instance, S: int | None = None, dtype=torch.float32, device="cuda"
):
    """Instance → (left, right, x, nl, S) tensors on ``device`` for the kernel.

    S defaults to n+1 padded up to a multiple of 128.
    """
    if S is None:
        S = inst.n + 1
    S = _pad_s(S)
    left = _tensor(inst.left, dtype, device)
    right = _tensor(inst.right, dtype, device)
    x = _tensor(inst.mult, torch.int32, device)
    nl = _tensor(inst.n_left(), dtype, device)
    return left, right, x, nl, S


def prepare_batch(
    instances: list[Instance],
    dtype=torch.int32,
    R_pad: int | None = None,
    S_pad: int | None = None,
    B_pad: int | None = None,
    device="cuda",
):
    """Pack instances into padded ``[B, R]`` tensors on ``device`` + shared ``S``.

    ``R_pad``/``S_pad``/``B_pad`` override the default tight padding (the
    batch maxima) — the bucket planner passes its power-of-two bucket shape so
    repeated launches share compiled programs.  File padding appends phantom
    files (zero width, zero multiplicity) at each instance's rightmost
    coordinate; batch padding appends all-phantom rows; see the module
    docstring for why both are result-preserving.
    """
    if not instances:
        raise ValueError("prepare_batch needs at least one instance")
    B = len(instances) if B_pad is None else max(B_pad, len(instances))
    R = max(i.n_req for i in instances) if R_pad is None else R_pad
    S = _pad_s(max(i.n for i in instances) + 1 if S_pad is None else S_pad)
    if R < max(i.n_req for i in instances):
        raise ValueError("R_pad smaller than the widest instance")
    if S_pad is not None and S_pad < max(i.n for i in instances) + 1:
        raise ValueError("S_pad smaller than the largest request count + 1")
    left = np.zeros((B, R), dtype=np.int64)
    right = np.zeros((B, R), dtype=np.int64)
    x = np.zeros((B, R), dtype=np.int64)
    u = np.zeros((B,), dtype=np.int64)
    for i, inst in enumerate(instances):
        r = inst.n_req
        left[i, :r] = inst.left
        right[i, :r] = inst.right
        left[i, r:] = inst.right[-1]
        right[i, r:] = inst.right[-1]
        x[i, :r] = inst.mult
        u[i] = inst.u_turn
    nl = np.concatenate(
        [np.zeros((B, 1), np.int64), np.cumsum(x, axis=1)[:, :-1]], axis=1
    )
    return (
        _tensor(left, dtype, device),
        _tensor(right, dtype, device),
        _tensor(x, torch.int32, device),
        _tensor(nl, dtype, device),
        _tensor(u, dtype, device),
        S,
    )


def rescale_instance(inst: Instance) -> tuple[Instance, int]:
    """Shift + gcd-reduce an instance for the int32 device table.

    Returns ``(scaled, g)`` with coordinates ``(coord - left[0]) // g`` where
    ``g = gcd`` of all shifted coordinates and the U-turn penalty.  Every DP
    term (base, skip, detour) is a linear combination of coordinate
    *differences* and ``U`` with scale-free integer coefficients, so the full
    table of ``scaled`` is exactly ``1/g`` times the original's and its argmin
    planes — the traceback — are identical.  Reconstruct original table values
    as ``g * T_scaled``.

    The scaled instance's ``m`` is set to its rightmost coordinate (the head
    start position never enters the device table — only *VirtualLB*, which the
    host computes from the original instance), which tightens the
    :func:`_check_int32_safe` bound to the requested span instead of the
    absolute tape length.
    """
    base = int(inst.left[0])
    g = 0
    for v in inst.left.tolist():
        g = math.gcd(g, v - base)
    for v in inst.right.tolist():
        g = math.gcd(g, v - base)
    g = math.gcd(g, inst.u_turn) or 1
    left = (inst.left - base) // g
    right = (inst.right - base) // g
    scaled = Instance(
        left=left,
        right=right,
        mult=inst.mult,
        m=int(right[-1]),
        u_turn=inst.u_turn // g,
    )
    return scaled, g


def _table_bound(inst: Instance) -> int:
    """Conservative bound on any candidate sum the kernel ever forms.

    Expanding any cell's recursion, the ``2 Δr (s + n_l)`` movement terms
    telescope to at most ``2n * 2m``, the base terms add at most ``2n * m``,
    and at most R detours each add ``2 U * 2n`` — so every cell is below
    ``2n (3m + R U)`` and every candidate sum below
    ``2n (7m + (2R + 1) U)``; we bound with ``2n (8m + (2R + 2) U)``.
    Callers pass :func:`rescale_instance` output, so ``m`` here is already the
    gcd-reduced *requested span*.
    """
    return 2 * inst.n * (8 * inst.m + (2 * inst.n_req + 2) * inst.u_turn)


def _check_int32_safe(instances: list[Instance]) -> None:
    """Magnitude guard for the int32 table: raising means the instance
    genuinely overflows even at tape-block granularity (after gcd/shift
    rescaling)."""
    for inst in instances:
        if _table_bound(inst) >= 2**31:
            raise ValueError(
                f"instance too large for the int32 device DP even after gcd "
                f"rescaling (m={inst.m}, n={inst.n}, R={inst.n_req}): rescale "
                f"coordinates to a coarser grain, use backend='python', or "
                f"opt into the exact float64 interpret fallback with "
                f"numeric_policy='f64'"
            )


def _check_f64_safe(instances: list[Instance]) -> None:
    """Exactness-domain guard for the float64 fallback (< 2**53)."""
    for inst in instances:
        if _table_bound(inst) >= 2**53:
            raise ValueError(
                f"instance too large even for the exact float64 device DP "
                f"(m={inst.m}, n={inst.n}, R={inst.n_req}): integer table "
                f"values would exceed 2**53; use backend='python'"
            )


def traceback_detours(choice: np.ndarray, mult: np.ndarray) -> list[tuple[int, int]]:
    """Replay an argmin plane ``choice[R, R, S]`` into the detour list.

    Iterative pre-order walk from the root cell ``(0, R-1, 0)``: ``-1`` means
    "skip b" (descend to ``(a, b-1, s + x_b)``), ``c`` means detour ``(c, b)``
    (emit it, descend into its inner structure ``(c, b, s)``, then resume with
    ``(a, c-1, s)``).  Matches the exact Python DP's emission order.
    """
    R = choice.shape[0]
    x = [int(v) for v in mult]
    detours: list[tuple[int, int]] = []
    work: list[tuple[int, int, int]] = [(0, R - 1, 0)]
    while work:
        a, b, s = work.pop()
        while a < b:
            c = int(choice[a, b, s])
            if c == -1:
                s += x[b]
                b -= 1
                continue
            detours.append((c, b))
            work.append((a, c - 1, s))
            a = c
    return detours


# ---------------------------------------------------------------------------
# solver entry points (int32 exact; float64 fallback)
# ---------------------------------------------------------------------------
def ltsp_solve_instance(
    inst: Instance,
    span: int | None = None,
    backend: str = "cuda",
    cand_tile: int = DEFAULT_CAND_TILE,
    disjoint: bool = False,
    numeric_policy: str = "strict",
    profile=None,
    device="cuda",
) -> tuple[int, list[tuple[int, int]]]:
    """Device-solved ``(opt_cost, detours)`` for one instance (exact)."""
    return ltsp_solve_batch([inst], span=span, backend=backend,
                            cand_tile=cand_tile, disjoint=disjoint,
                            numeric_policy=numeric_policy, profile=profile,
                            device=device)[0]


def _solve_packed(
    originals: list[Instance],
    scaled: list[Instance],
    gs: list[int],
    R_pad: int | None,
    S_pad: int | None,
    B_pad: int | None,
    span: int | None,
    backend: str,
    cand_tile: int,
    disjoint: bool = False,
    dtype=torch.int32,
    capture: bool = False,
    device="cuda",
) -> tuple[list[tuple[int, list[tuple[int, int]]]], list[DenseStore | None]]:
    """One padded device table build; results refer to the *original*
    instances.

    ``capture=True`` additionally snapshots each instance's dense value and
    argmin planes into a :class:`~repro_torch.core.warm.DenseStore` (kept in
    the launch's gcd-rescaled units together with ``g``, so lookups
    reconstruct original-unit values with python-int arithmetic).  The
    device tables are released before returning.
    """
    left, right, x, nl, u, S = prepare_batch(
        scaled, dtype=dtype, R_pad=R_pad, S_pad=S_pad, B_pad=B_pad, device=device
    )
    tables = ltsp_dp_tables if backend == "cuda" else ltsp_dp_tables_ref
    T, C = tables(
        left, right, x, nl, u, S=S, span=span, disjoint=disjoint,
        cand_tile=cand_tile,
    )
    R = left.shape[1]
    # the whole argmin plane goes to the host for the traceback
    C_host = C.cpu().numpy()
    T_root = T[:, 0, R - 1, 0].cpu().numpy()
    T_host = T.cpu().numpy() if capture else None
    del T, C  # free this bucket's device tables before the next one
    out = []
    stores: list[DenseStore | None] = []
    x_host = x.cpu().numpy()
    for i, (inst, g) in enumerate(zip(originals, gs)):
        dets = traceback_detours(C_host[i], x_host[i])
        # padding only ever skips, so emitted detours stay within the real
        # files; guard the invariant anyway.
        assert all(b < inst.n_req for _, b in dets)
        # the scaled table is exactly 1/g of the original's (see
        # rescale_instance); VirtualLB comes from the original coordinates.
        cost = g * int(T_root[i]) + virtual_lb(inst)
        out.append((cost, dets))
        if capture:
            prefix = np.cumsum(inst.mult).tolist()
            stores.append(
                DenseStore(T_host[i].copy(), C_host[i].copy(), g, inst.n, prefix)
            )
        else:
            stores.append(None)
    return out, stores


def ltsp_solve_batch(
    instances: list[Instance],
    span: int | None = None,
    backend: str = "cuda",
    bucketed: bool = True,
    cand_tile: int = DEFAULT_CAND_TILE,
    disjoint: bool = False,
    numeric_policy: str = "strict",
    capture: bool = False,
    profile=None,
    device="cuda",
) -> list[tuple[int, list[tuple[int, int]]]]:
    """Solve several instances in a few size-bucketed device launches.

    Returns one ``(opt_cost, detours)`` per instance, in order.  ``opt_cost``
    is ``g * T[0, R_pad-1, 0] + VirtualLB`` taken from the gcd-rescaled int32
    device table — exact under the :func:`_check_int32_safe` bound; detour
    indices refer to each instance's own (unpadded) requested files.

    ``bucketed=True`` (default) launches one wavefront per
    :func:`plan_buckets` shape bucket — tight shapes for heterogeneous
    batches, jit-cache-friendly powers-of-two padding.  ``bucketed=False``
    reproduces the seed behaviour (every instance padded to the global batch
    maxima, one launch) and exists for A/B benchmarking.

    ``numeric_policy="f64"`` re-routes the instances that fail the int32
    magnitude guard after gcd/shift rescaling through an exact float64
    table, one tight launch each, instead of raising (see the module
    docstring); the int32-safe ones still take the int32 launches unchanged.

    ``capture=True`` changes the return to ``(results, stores)`` where
    ``stores[i]`` is a :class:`~repro.core.warm.DenseStore` snapshot of
    instance ``i``'s dense value/argmin planes — the raw material for
    warm-starting the next solve of a perturbed sibling (see
    :func:`ltsp_solve_batch_warm`).

    ``profile`` takes any object with a ``wall`` flag and a ``record``
    method of the JAX package's ``KernelProfile`` signature: every table
    build records its padded bucket shape, the exact real-vs-padded DP cell
    counts, a signature whose fifth field says whether the plain version
    (``backend="torch"``) ran, and (when ``profile.wall`` is set) the host
    wall time around the build, the copy of ``C`` to the host and the
    traceback — pure host-side accounting, results unchanged.
    """
    if not instances:
        return ([], []) if capture else []
    _check_backend(backend, device)
    pairs = [rescale_instance(inst) for inst in instances]
    scaled = [p[0] for p in pairs]
    gs = [p[1] for p in pairs]
    if numeric_policy == "f64":
        wide = [i for i, s in enumerate(scaled) if _table_bound(s) >= 2**31]
        _check_f64_safe([scaled[i] for i in wide])
    else:
        wide = []
        _check_int32_safe(scaled)
    wide_set = set(wide)
    narrow = [i for i in range(len(instances)) if i not in wide_set]

    stores: list[DenseStore | None] = [None] * len(instances)

    plain = backend == "torch"

    def solve(idxs, R_pad, S_pad, B_pad, dtype=torch.int32):
        t0 = (
            time.perf_counter_ns()
            if profile is not None and profile.wall
            else None
        )
        out, subs = _solve_packed(
            [instances[i] for i in idxs],
            [scaled[i] for i in idxs],
            [gs[i] for i in idxs],
            R_pad, S_pad, B_pad, span,
            backend, cand_tile,
            disjoint=disjoint, dtype=dtype, capture=capture, device=device,
        )
        for i, st in zip(idxs, subs):
            stores[i] = st
        if profile is not None:
            # mirror prepare_batch's padding defaults so the record reports
            # the launch shape that actually ran
            sub = [scaled[i] for i in idxs]
            B_eff = len(sub) if B_pad is None else max(B_pad, len(sub))
            R_eff = max(s.n_req for s in sub) if R_pad is None else R_pad
            S_eff = _pad_s(max(s.n for s in sub) + 1 if S_pad is None else S_pad)
            profile.record(
                signature=(
                    R_eff, S_eff, B_eff, str(dtype).removeprefix("torch."),
                    plain, span, disjoint, cand_tile,
                ),
                n_instances=len(sub),
                R_pad=R_eff,
                S_pad=S_eff,
                B_pad=B_eff,
                real_cells=sum(s.n_req * s.n_req * (s.n + 1) for s in sub),
                interpret=plain,
                wall_ns=(
                    time.perf_counter_ns() - t0 if t0 is not None else None
                ),
            )
        return out

    def done(results):
        return (results, stores) if capture else results

    results: list[tuple[int, list[tuple[int, int]]] | None] = [None] * len(instances)
    if wide:
        # float64: one tight launch per instance at its bucket shape, as in
        # the JAX package, so launch shapes, cell counts and DenseStore sizes
        # match it instance for instance.
        for i in wide:
            R_pad, S_pad = bucket_shape(scaled[i])
            [results[i]] = solve([i], R_pad, S_pad, None, dtype=torch.float64)
    if not narrow:
        return done(results)  # type: ignore[return-value]
    if not bucketed:  # seed behaviour: one launch padded to the batch maxima
        for i, res in zip(narrow, solve(narrow, None, None, None)):
            results[i] = res
        return done(results)  # type: ignore[return-value]
    if len(narrow) == 1:  # fast path: no planner, one tight launch
        [i] = narrow
        R_pad, S_pad = bucket_shape(scaled[i])
        [results[i]] = solve([i], R_pad, S_pad, None)
        return done(results)  # type: ignore[return-value]
    for (R_pad, S_pad), sub in plan_buckets([scaled[i] for i in narrow]).items():
        idxs = [narrow[j] for j in sub]
        for idx, res in zip(idxs, solve(idxs, R_pad, S_pad, _pow2(len(idxs)))):
            results[idx] = res
    return done(results)  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# warm-start entry points
# ---------------------------------------------------------------------------
def ltsp_solve_instance_warm(
    inst: Instance,
    span: int | None = None,
    warm: WarmState | None = None,
    backend: str = "cuda",
    cand_tile: int = DEFAULT_CAND_TILE,
    numeric_policy: str = "strict",
    profile=None,
    device="cuda",
) -> tuple[int, list[tuple[int, int]], WarmState | None, WarmStats]:
    """Warm-startable single-instance solve (see :func:`ltsp_solve_batch_warm`)."""
    results, warms, stats = ltsp_solve_batch_warm(
        [inst], [warm], span=span, backend=backend,
        cand_tile=cand_tile, numeric_policy=numeric_policy, profile=profile,
        device=device,
    )
    (cost, dets) = results[0]
    return cost, dets, warms[0], stats[0]


def ltsp_solve_batch_warm(
    instances: list[Instance],
    warms: list[WarmState | None] | None = None,
    span: int | None = None,
    backend: str = "cuda",
    bucketed: bool = True,
    cand_tile: int = DEFAULT_CAND_TILE,
    numeric_policy: str = "strict",
    profile=None,
    device="cuda",
) -> tuple[
    list[tuple[int, list[tuple[int, int]]]],
    list[WarmState | None],
    list[WarmStats],
]:
    """Warm-startable batch solve, bit-identical to :func:`ltsp_solve_batch`.

    Instances whose :class:`~repro.core.warm.WarmState` aligns (same U-turn
    penalty and span, at least one matching file run — see
    :func:`repro.core.warm.align_warm`) re-evaluate **only the invalidated
    cells on the host**, in exact python ints, reading every still-valid cell
    out of the warm store: a device relaunch would recompute the whole dense
    table, which is precisely the work warm-starting exists to avoid, and
    the host incremental path is bit-identical to the device wavefront (the
    python and device backends are pinned bit-identical by the kernel parity
    tests, and warm-vs-cold identity is asserted differentially on top).
    Everything else takes the normal bucketed device launches with
    ``capture=True``, so each cold solve yields a dense
    :class:`~repro.core.warm.DenseStore` warm state for the next tick.

    The numeric-policy magnitude guards run for *every* instance first —
    including warm-aligned ones, which the guards' failure modes could
    otherwise bypass — so strict-mode error behaviour matches the cold path
    exactly.  Returns ``(results, new_warm_states, stats)``, all parallel to
    ``instances``.
    """
    if not instances:
        return [], [], []
    _check_backend(backend, device)
    if warms is None:
        warms = [None] * len(instances)
    # same guard discipline as the cold path (before any solving: a batch
    # never fails mid-flight)
    scaled = [rescale_instance(inst)[0] for inst in instances]
    if numeric_policy == "f64":
        _check_f64_safe([s for s in scaled if _table_bound(s) >= 2**31])
    else:
        _check_int32_safe(scaled)

    from ...core.dp import dp_schedule_warm

    results: list[tuple[int, list[tuple[int, int]]] | None] = [None] * len(instances)
    new_warms: list[WarmState | None] = [None] * len(instances)
    stats: list[WarmStats | None] = [None] * len(instances)
    cold: list[int] = []
    for i, (inst, warm) in enumerate(zip(instances, warms)):
        if align_warm(warm, inst, span) is not None:
            cost, dets, new_warm, st = dp_schedule_warm(inst, span=span, warm=warm)
            results[i], new_warms[i], stats[i] = (cost, dets), new_warm, st
        else:
            cold.append(i)
    if cold:
        solved, stores = ltsp_solve_batch(
            [instances[i] for i in cold], span=span, backend=backend,
            bucketed=bucketed, cand_tile=cand_tile,
            numeric_policy=numeric_policy, capture=True, profile=profile,
            device=device,
        )
        for i, res, store in zip(cold, solved, stores):
            results[i] = res
            new_warms[i] = (
                warm_from_instance(instances[i], span, store)
                if store is not None else None
            )
            # honest device work accounting: the wavefront evaluates every
            # dense cell of the padded launch shape
            stats[i] = WarmStats(cells_evaluated=len(store) if store else 0)
    return results, new_warms, stats  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# value-only f32 wrappers
# ---------------------------------------------------------------------------
def ltsp_dp_table(left, right, x, nl, u_turn: float, S: int, device="cuda"):
    """Dense single-instance DP value table (the table type is ``left``'s).

    On a CUDA ``device`` the kernel builds it, on the CPU the plain version.
    """
    T, _ = ltsp_dp_tables(
        left[None], right[None], x[None], nl[None],
        torch.tensor([u_turn], dtype=left.dtype), S=S, device=device,
    )
    return T[0]


def ltsp_opt(left, right, x, nl, u_turn: float, m: float, S: int, device="cuda"):
    """Optimal LTSP objective (float): ``T[0, R-1, 0] + VirtualLB``."""
    T = ltsp_dp_table(left, right, x, nl, u_turn, S, device=device)
    f32 = torch.float32
    left = left.to(T.device)
    virt = torch.sum(
        x.to(T.device, f32) * (m - left + (right.to(T.device) - left) + u_turn)
    )
    return T[0, left.shape[0] - 1, 0] + virt


def ltsp_opt_instance(inst: Instance, device="cuda") -> float:
    """Convenience: exact-instance adapter (f32; exact for coords < 2**20)."""
    left, right, x, nl, S = prepare_arrays(inst, device=device)
    val = ltsp_opt(
        left, right, x, nl, float(inst.u_turn), float(inst.m), S, device=device
    )
    return float(val)
