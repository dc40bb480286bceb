"""The program's host-clock spans of the traced pass, for the metrics that
read them.

The program keeps one span log, ``repro_torch.obs.trace.HOST_SPANS``, armed
only while a ``torch.profiler`` session records: in a run of this
benchmark, only over the traced pass.  Each mount's ``solve`` is one
``ltsp.solve`` root, and its children (``ltsp.prepare``, ``ltsp.tables``,
``ltsp.wait``, ``ltsp.traceback``, ``ltsp.finish``) share its solve id.
"""

from __future__ import annotations

import collections


def traced_mounts(run: dict) -> list[tuple] | None:
    """``[(root, tree)]`` of the traced pass's mounts (see :func:`mounts_of`);
    ``None`` where the run is not traced."""
    prof = run.get("profile")
    if not prof or run.get("kind") != "mounts" or not prof["solves"]:
        return None
    return mounts_of(prof["solves"])


def mounts_of(solves: list[dict]) -> list[tuple] | None:
    """``[(root, tree)]`` of the last ``len(solves)`` ``ltsp.solve`` roots in
    the log, in order, each with every span of its solve id in opening
    order.  ``None`` where the program keeps no such log or the roots'
    ``(n_req, n)`` are not the solves'."""
    try:
        from repro_torch.obs.trace import HOST_SPANS
    except ImportError:  # a program without the span log
        return None
    spans = sorted(HOST_SPANS.spans, key=lambda s: s.seq)
    roots = [s for s in spans if s.name == "ltsp.solve" and s.parent is None][-len(solves):]
    if [(r.attrs.get("n_req"), r.attrs.get("n")) for r in roots] != [
            (s["n_req"], s["n"]) for s in solves]:
        return None
    trees = collections.defaultdict(list)
    for s in spans:
        trees[s.solve].append(s)
    return [(r, trees[r.solve]) for r in roots]


def named(tree: list, name: str, what: str | None = None) -> list:
    """The spans ``name`` of a tree (``ltsp.wait``s waiting for ``what``)."""
    return [s for s in tree if s.name == name and (what is None or s.attrs.get("what") == what)]


def split(mounts: list[tuple]) -> dict[str, float]:
    """Milliseconds a mount in each span, the mean over the mounts, by name
    (``ltsp.wait`` by what it waits for); ``ltsp.solve`` is the whole root."""
    out: dict[str, float] = collections.defaultdict(float)
    for _, tree in mounts:
        for s in tree:
            key = s.name + (f"[{s.attrs['what']}]" if "what" in s.attrs else "")
            out[key] += (s.t1 - s.t0) / 1e6 / len(mounts)
    return dict(out)
