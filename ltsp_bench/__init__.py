"""The benchmark of ``repro_torch``: one cell a run, ``ltsp_bench/run.py``."""
