"""Fault tolerance at pod scale: straggler detection + elastic re-meshing.

These are the pure control-plane pieces: detecting slow/dead workers from
step-duration telemetry, deriving a survivor mesh, and scaling the batch.
They are exercised by tests and by the training example's simulated
preemption; on a real cluster the same plans drive
``torch.distributed``/coordinator restarts.  The port's copy of the JAX
package's module, which is framework-free.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Iterable

__all__ = ["StragglerMonitor", "RemeshPlan", "remesh_plan", "should_checkpoint"]


class StragglerMonitor:
    """Per-worker step-duration telemetry with EMA and robust flagging."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.ema: dict[str, float] = {}
        self.last_seen: dict[str, int] = {}

    def record(self, worker: str, step: int, duration_s: float) -> None:
        prev = self.ema.get(worker)
        self.ema[worker] = (
            duration_s if prev is None else (1 - self.alpha) * prev + self.alpha * duration_s
        )
        self.last_seen[worker] = step

    def stragglers(self, threshold: float = 2.0) -> list[str]:
        """Workers whose EMA step time exceeds ``threshold x`` the median."""
        if len(self.ema) < 2:
            return []
        med = statistics.median(self.ema.values())
        return sorted(w for w, v in self.ema.items() if v > threshold * med)

    def dead(self, current_step: int, max_lag: int = 3) -> list[str]:
        """Workers that have not reported for ``max_lag`` steps."""
        return sorted(
            w for w, s in self.last_seen.items() if current_step - s > max_lag
        )


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    """Elastic-scaling decision after losing devices."""

    shape: tuple[int, ...]  # new mesh shape
    axis_names: tuple[str, ...]
    devices_used: int
    devices_dropped: int
    batch_scale: float  # new global batch as a fraction of the old
    reshard_model_axis: bool  # params must move (expensive) vs pure DP shrink


def remesh_plan(
    alive_devices: int,
    old_shape: tuple[int, ...],
    axis_names: tuple[str, ...] = ("data", "model"),
) -> RemeshPlan:
    """Largest survivor mesh that preserves the model axis if possible.

    Preference order: (1) keep the model axis intact and shrink the data
    (and pod) axes — parameters stay put, only the batch shrinks; (2) if even
    one model-axis replica no longer fits, shrink the model axis to the
    largest power-of-two divisor that fits (requires parameter resharding).
    """
    *rest, model = old_shape
    data_total = 1
    for r in rest:
        data_total *= r
    if alive_devices >= model:
        new_data = alive_devices // model
        # fold pods back in if the pod axis survives whole multiples
        if len(rest) == 2:  # (pod, data)
            pod, data = rest
            new_pod = max(1, min(pod, new_data // data)) if data <= new_data else 1
            new_data_axis = new_data // new_pod
            shape = (new_pod, new_data_axis, model)
        else:
            shape = (new_data, model)
        used = new_data * model
        return RemeshPlan(
            shape=shape,
            axis_names=axis_names,
            devices_used=used,
            devices_dropped=alive_devices - used,
            batch_scale=new_data / data_total,
            reshard_model_axis=False,
        )
    # degraded mode: shrink model axis
    new_model = 1
    while new_model * 2 <= alive_devices and model % (new_model * 2) == 0:
        new_model *= 2
    new_data = alive_devices // new_model
    shape = (new_data, new_model) if len(rest) == 1 else (1, new_data, new_model)
    return RemeshPlan(
        shape=shape,
        axis_names=axis_names,
        devices_used=new_data * new_model,
        devices_dropped=alive_devices - new_data * new_model,
        batch_scale=new_data / data_total,
        reshard_model_axis=True,
    )


def should_checkpoint(step: int, every: int, alarms: Iterable[str]) -> bool:
    """Periodic checkpointing, forced early when stragglers/dead detected."""
    return step % every == 0 or bool(list(alarms))
