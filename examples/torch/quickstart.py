"""Quickstart: schedule a batch of tape reads with the paper's exact DP.

Builds a small tape, issues a request batch, and compares every registered
scheduling policy's mean service time via the solver engine — then re-solves
the optimal policy on the device backend (the CUDA kernels on the card by
default) and checks it reproduces the exact schedule cost.  Also renders the
head trajectory of the optimal schedule as ASCII art.

Run: PYTHONPATH=src python examples/torch/quickstart.py
     [--backend cuda|torch|python] [--device cuda|cpu]
"""

import argparse

import numpy as np

from repro_torch.core import ExecutionContext, list_solvers, service_times, virtual_lb
from repro_torch.storage.tape import Tape, schedule_reads


def render_trajectory(inst, detours, width=78):
    """ASCII sketch of the head trajectory implied by a detour list."""
    scale = width / inst.m
    print(" tape:", "".join(
        "#" if any(l <= p / scale < r for l, r in zip(inst.left, inst.right)) else "."
        for p in range(width)
    ))
    t = service_times(inst, detours)
    for i in np.argsort(t):
        bar = int(inst.left[i] * scale)
        size = max(1, int((inst.right[i] - inst.left[i]) * scale))
        print(f"  t={int(t[i]):>8d} |{' ' * bar}{'=' * size}  x{inst.mult[i]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cuda", help="device backend of the re-solve")
    ap.add_argument("--device", default="cuda", help="torch device of that backend")
    args = ap.parse_args()

    rng = np.random.default_rng(42)
    tape = Tape("DEMO", capacity=1_000_000, u_turn=2_000)
    for i in range(14):
        tape.append(f"file{i:02d}", int(rng.integers(10_000, 90_000)))

    requests = {f"file{i:02d}": int(rng.integers(1, 9)) for i in [1, 3, 4, 7, 8, 11, 13]}
    print("request batch:", requests, "\n")

    print(f"{'policy':<10} {'mean service':>14} {'vs optimal':>11}")
    plans = {}
    for policy in list_solvers():
        plans[policy] = schedule_reads(tape, requests, policy=policy)
    opt = plans["dp"].mean_service
    for policy, plan in sorted(plans.items(), key=lambda kv: kv[1].mean_service):
        print(f"{policy:<10} {plan.mean_service:>14.1f} {plan.mean_service / opt:>10.3f}x")

    # same policy, device backend: the table build + traceback must land on a
    # schedule with the identical optimal cost
    dev = schedule_reads(
        tape, requests, policy="dp",
        context=ExecutionContext(backend=args.backend, device=args.device),
    )
    assert dev.total_cost == plans["dp"].total_cost
    print(f"\n{args.backend} backend reproduces OPT = {dev.total_cost} exactly")

    inst, _ = tape.instance(requests)
    print(f"VirtualLB = {virtual_lb(inst)}, OPT = {plans['dp'].total_cost}")
    print("optimal detours:", plans["dp"].detours)
    print("\noptimal head trajectory (files served in this order):")
    render_trajectory(inst, plans["dp"].detours)


if __name__ == "__main__":
    main()
