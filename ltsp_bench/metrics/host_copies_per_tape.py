"""Copies between host and device a mount in the traced pass: the
``copies`` the program counts into its host-clock spans (each
``_tensor`` to the device and each ``_to_host``), summed over a mount's
spans, the mean over the pass."""

from ltsp_bench.host_spans import traced_mounts


def read(run: dict):
    mounts = traced_mounts(run)
    if mounts is None:
        return None
    return sum(s.attrs.get("copies", 0) for _, tree in mounts for s in tree) / len(mounts)
