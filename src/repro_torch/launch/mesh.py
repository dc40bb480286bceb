"""Production mesh construction (a function, not a constant: importing this
module touches no process group).

The port's copy of the JAX package's ``launch/mesh.py``: a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, with the reference's shapes and axis names.  On
H100s a 16-wide "model" axis spans two 8-GPU NVLink domains, so its
collectives cross the slower inter-node links; the shapes stay the
reference's all the same, because the sharding rules' divisibility (and so
every cell's layout) depends on them.
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "PODS", "POD_SHAPE"]

PODS = 2
POD_SHAPE = (16, 16)  # 256 devices per pod


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """16x16 single-pod mesh or 2x16x16 two-pod mesh over the process group's
    first ranks.

    Axis semantics: "pod" — pure data parallelism across pods (gradient
    all-reduce over the inter-pod links); "data" — in-pod data parallelism;
    "model" — tensor/expert parallelism (and KV-cache sequence sharding for
    decode).  ``device_type`` defaults to ``cuda`` under NCCL, else ``cpu``.
    """
    import torch.distributed as dist

    shape = (PODS, *POD_SHAPE) if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}; have {have} "
            f"(start {n} ranks with torchrun --nproc-per-node, or run the dry run, "
            f"python -m repro_torch.launch.dryrun, whose fake process group has them)"
        )
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)
