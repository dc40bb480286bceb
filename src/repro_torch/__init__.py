"""PyTorch and CUDA port of the LTSP tape-scheduling system.

Stands beside the JAX package ``repro`` (the reference, which it never
imports) with the same layout: ``core`` (instances, the paper's DP and
heuristics, the solver engine), ``data`` (seeded IN2P3-like workloads),
``kernels.ltsp_dp`` (the DP wavefront as a hand-written CUDA kernel plus its
plain torch version), ``storage`` (the tape library), ``serving`` (the
online serving stack and the schedule replay oracle), ``obs``
(observability), ``fleet`` (N libraries federated behind one arrival stream),
``configs`` and ``models`` (the language-model scaffolding: the ten
architectures, the dense decoder's serving path) and ``launch`` (the serving
command line).  Device entry points run on
the card unless the caller asks for the CPU.
"""
