"""The share of the far fold's block-stages that the traced pass's table
builds staged, of those they would stage from every block's first far start
on: Σ ``far_stages`` over Σ ``far_stages_full`` of the program's
``ltsp.tables`` spans.  Under a LOGDP span a block stages only from its
lowest live start, so the share falls below 1; it is 1 where every far start
is staged.  Nothing off the card or where the spans carry no such counts."""

from ltsp_bench.host_spans import named, traced_mounts


def read(run: dict):
    mounts = traced_mounts(run)
    if mounts is None:
        return None
    builds = [t for _, tree in mounts for t in named(tree, "ltsp.tables")]
    if not builds or any("far_stages" not in t.attrs or "far_stages_full" not in t.attrs
                         for t in builds):
        return None
    full = sum(t.attrs["far_stages_full"] for t in builds)
    if full == 0:  # no build had a far launch
        return None
    return sum(t.attrs["far_stages"] for t in builds) / full
