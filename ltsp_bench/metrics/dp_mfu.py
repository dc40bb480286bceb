"""The whole solve's share of the card's peak, in %: the least time of
every table built in the traced pass over that pass's wall time, from the
call into the solver down to the plans on the host."""


def read(run: dict):
    prof = run.get("profile")
    if not prof or run.get("kind") != "mounts" or prof["window_s"] <= 0:
        return None
    if prof["busy_s"] <= 0:  # nothing ran on a device
        return None
    return 100.0 * sum(s["least_s"] for s in prof["solves"]) / prof["window_s"]
