"""Set-up time, in seconds, from the process's start to the window's:
imports, building or loading the kernels, making the inputs, warming up
every shape the window uses (host clock)."""


def read(run: dict):
    return run["setup_s"]
