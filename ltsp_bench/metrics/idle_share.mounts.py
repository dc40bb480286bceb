"""Share of the traced pass, in %, in which no kernel, copy or fill ran on
the card (the profiler's device events, their union against the pass's
wall)."""


def read(run: dict):
    prof = run.get("profile")
    if not prof or run.get("kind") != "mounts" or prof["window_s"] <= 0:
        return None
    if prof["busy_s"] <= 0:  # nothing ran on a device
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
