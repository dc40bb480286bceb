"""PyTorch and CUDA port of the LTSP tape-scheduling system.

Stands beside the JAX package ``repro`` (the reference, which it never
imports) with the same layout: ``core`` (instances, the paper's DP and
heuristics, the solver engine), ``data`` (seeded IN2P3-like workloads),
``kernels.ltsp_dp`` (the DP wavefront as a hand-written CUDA kernel plus its
plain torch version), ``storage`` (the tape library), ``serving`` (the
online serving stack and the schedule replay oracle), ``obs``
(observability), ``fleet`` (N libraries federated behind one arrival stream),
``configs`` and ``models`` (the language-model scaffolding: the ten
architectures, dense, MoE and MLA, Mamba and xLSTM, cross-attention and
encoder-decoder, each served and trained), ``training`` (AdamW, the train
step with remat and microbatches), ``distributed`` (checkpoints, the
sharding rules and mesh hints, gradient compression, fault tolerance) and
``launch`` (the serving and training command lines, the production mesh,
the abstract input specs and the multi-pod dry run).  Device entry points
run on the card unless the caller asks for the CPU.
"""
