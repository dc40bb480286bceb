"""What the benchmark reads from the device trace and from the host.

:func:`profiled` runs a block under ``torch.profiler`` inside a range named
:data:`WINDOW`; :func:`device_summary` reduces the raw events to the
seconds each device operation took, the device's busy time (the union of
every kernel, copy and fill) inside the window, and the idle gaps between
them, each named after the innermost host event that was running at its
middle.
"""

from __future__ import annotations

import bisect
import collections
import contextlib

#: the range the profiled block runs in; its span is the traced window
WINDOW = "ltsp_bench.window"
#: host events searched back from a gap's middle for the one running there
_LOOKBACK = 64
#: what a gap is named when no host event covers its middle
PYTHON = "host python (no operator)"


@contextlib.contextmanager
def profiled(device: str):
    """``with profiled(dev) as box:`` profiles the block; ``box["prof"]``
    holds the profiler once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    box: dict = {}
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield box
            if device.startswith("cuda"):
                torch.cuda.synchronize()
    box["prof"] = prof


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def device_summary(prof, top: int = 10) -> dict:
    """``{"window_s", "busy_s", "by_name": {name: s}, "device_ops": [[name, s]],
    "idle_gaps": [[what the host did, s]]}`` of a :func:`profiled` run."""
    from torch.autograd import DeviceType

    window = None
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        lo, hi = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CPU:
            if e.name() == WINDOW:
                window = (lo, hi)
            else:
                host.append((lo, hi, e.name()))
        elif e.name() != WINDOW and not getattr(e, "is_user_annotation", bool)():
            # a range's mark on the device's timeline is not device work
            dev.append((lo, hi, short_name(e.name())))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = window
    by_name: dict[str, float] = collections.defaultdict(float)
    clipped = []
    for lo, hi, name in dev:
        lo, hi = max(lo, w0), min(hi, w1)
        if hi > lo:
            by_name[name] += (hi - lo) / 1e9
            clipped.append((lo, hi))
    busy = _merge(clipped)
    host.sort()
    starts = [h[0] for h in host]
    gaps: dict[str, float] = collections.defaultdict(float)
    edges = [w0] + [v for iv in busy for v in iv] + [w1]
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi > lo:
            gaps[_host_at(host, starts, (lo + hi) // 2)] += (hi - lo) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(hi - lo for lo, hi in busy) / 1e9,
        "by_name": dict(by_name),
        "device_ops": [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
    }


def short_name(name: str) -> str:
    """A device operation's name without its argument list: ``void
    (anonymous namespace)::far_fold_kernel<double, 8, false>(double*, ...)``
    reads ``far_fold_kernel<double, 8, false>``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = next((i for i, ch in enumerate(name) if ch == "(" and i and name[i - 1] != " "),
               len(name))
    return name[:cut].strip()[:120]


def kernel_seconds(summary: dict, kernel: str) -> float:
    """Device seconds of every instantiation of the ``__global__`` function
    ``kernel`` in a :func:`device_summary`."""
    return sum(s for name, s in summary["by_name"].items()
               if name == kernel or name.startswith(kernel + "<")
               or name.endswith("::" + kernel) or ("::" + kernel + "<") in name)


def _host_at(host: list, starts: list, t: int) -> str:
    """The innermost host event running at ``t``: the latest started of
    those that cover it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - _LOOKBACK), -1):
        lo, hi, name = host[j]
        if lo <= t <= hi:
            return name
    return PYTHON
