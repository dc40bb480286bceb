"""Serving launcher of the port: batched greedy decoding of a language model,
optionally after an LTSP-planned restore from the tape archive, and the two
tape-serving modes (one library, or a federation of them).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --reduced \
      --batch 8 --new-tokens 32 --restore-from-tape
  PYTHONPATH=src python -m repro_torch.launch.serve --serve-tape-queue \
      --tape-requests 150 --tape-drives 2 --tape-mount-cost 150000
  PYTHONPATH=src python -m repro_torch.launch.serve --serve-tape-fleet \
      --tape-requests 90 --fleet-outage-at 1500000 --fleet-outage-shard 1

Everything runs on the card by default: the model on ``--tape-device cuda``,
and every DP table build (of the restore plan and of the tape modes) with
the hand-written CUDA kernels (``--tape-backend cuda``).  ``--tape-backend
torch --tape-device cpu`` runs the model and the same tables (their plain
torch version) on the CPU, and ``--tape-backend python`` runs the exact host
DP; all three print the same plans and tables (the ``cells`` and ``reused``
columns count dense table cells on ``cuda``/``torch`` and real DP cells on
``python``).  Every context is built with ``numeric_policy="f64"``: an
instance past the int32 device guard is solved exactly in a float64 table
on the same device.  Nothing falls back: a backend that cannot run (``cuda``
without a card) raises with its own message.

Language-model serving
----------------------
Without a tape mode the launcher serves ``--arch`` (``--reduced`` for the
smoke-test size): parameters drawn from a generator seeded 0, prompts from
one seeded 1, a teacher-forced prefill of ``--prompt-len`` tokens through
the decode step, then ``--new-tokens`` greedy steps; it prints the tokens/s
and the first sequence.  ``--restore-from-tape`` first archives the
parameters to a simulated tape library and plans their restore with
``--tape-policy`` (the cold start of a serving fleet), printing the mean
shard arrival.  At full width the reference's 4 MB cartridges cannot hold
the embedding shard, and the archive raises ``tape ... full`` in both
packages.  When a process group is up (under ``torchrun``, or one the
caller started) the model serves on a mesh at any world size, one
included: the training launcher's ``_auto_mesh`` over the group's ranks,
the parameters placed by ``param_pspecs``, the decode cache by
``cache_pspecs`` (sequence-sharded over "model"), the prompts by batch, and
the steps run with the mesh active.  Without one, ``--mesh auto`` serves on
one device and ``--mesh pod|multipod`` raises the reference's
``RuntimeError`` (``need 256 devices ...``).  Every architecture serves: the MoE ones
(DeepSeek-V2, Kimi-K2), the recurrent ones (Jamba, xLSTM: their Mamba,
mLSTM and sLSTM states decoded in place) and the two with cross-attention
(Llama-3.2-Vision, Seamless), which decode against the zero cross caches
``init_cache`` gives, as the reference launcher does: it warms no cross
cache.

Online tape serving (``--serve-tape-queue``)
--------------------------------------------
Read requests arrive while drives are busy, so batch composition — and,
with a shared :class:`~repro_torch.serving.drives.DrivePool`, *which
cartridge each drive mounts next* — is a scheduling decision.  This mode
drives :mod:`repro_torch.serving.queue`: per-cartridge request queues,
``--tape-drives`` drives shared across all cartridges (default: one per
cartridge), an explicit mount cost model (``--tape-mount-cost`` /
``--tape-unmount-cost`` / ``--tape-load-seek``), and an **admission
policy** (``--tape-admission``, ``all`` sweeps every one):

* ``fifo`` / ``fifo-global`` — per-request solving in global arrival order
  (every request pays a full seek from the load point; the baseline);
* ``accumulate`` / ``per-drive-accumulate`` — accumulate-then-solve: a free
  drive mounts the cartridge whose oldest request has waited
  ``--tape-window`` time units and serves its whole queue (``0`` = greedy
  batching on drive-free);
* ``preempt`` — greedy batching plus preemptive re-solve: an arrival mid-batch
  aborts the in-flight plan, keeps already-served completions, rewinds, and
  re-solves the survivors together with the newcomer;
* ``batched`` — cross-cartridge device batching: all mount-ready cartridges
  in an event tick are planned via a **single** ``solve_batch`` bucketed
  launch;
* ``edf-global`` / ``slack-accumulate`` — the deadline-aware (QoS)
  admissions.  They need deadlines on the trace: pass ``--tape-tightness``
  to annotate the generated trace
  (:func:`repro_torch.data.traces.qos_poisson_trace`) or replay a recorded
  one.

``--trace-file PATH`` replays a JSONL trace (:mod:`repro_torch.data.traces`)
instead of generating one; ``--record-trace PATH`` writes the served trace
(round-trips bit-exactly).  ``--tape-scheduler`` picks the drive-eviction
policy.  With deadlines present the table gains deadline-miss columns, and
``--slo-target RATE`` turns the run into a check: exit status 1 unless some
swept admission meets the target miss rate.  ``--tape-selector`` (any of
``repro_torch.core.list_selectors()``) re-picks the solve policy each tick
from queue depth and recorded solve timings, under the per-tick DP cell
budget ``--tape-budget``; the table gains a ``policy_mix`` column.
Re-solving admissions warm-start each cartridge's DP from the previous
tick's table unless ``--no-tape-warm``; ``--tape-cache-file PATH`` persists
the solve memo as a :class:`~repro_torch.core.JsonlCacheBackend`.
``--tape-trace-out`` / ``--tape-metrics-out`` export the opt-in
:class:`~repro_torch.obs.Observability` bundle (JSONL spans plus a Chrome
trace, a Prometheus snapshot) of a single-admission run.
``--tape-fault-profile light|heavy`` injects a seeded
:class:`~repro_torch.serving.faults.FaultPlan` with a ``--tape-retries``-deep
retry budget per fault site; ``--tape-journal PATH`` writes a write-ahead
event journal and, pointed at a torn one, recovers from it bit-identically.

Fleet federation (``--serve-tape-fleet``)
-----------------------------------------
``--fleet-shards`` per-library shards (:mod:`repro_torch.fleet`) serve one
arrival stream in shared exact virtual time, each logical file stored on
``--fleet-replicas`` shards, and ``--fleet-placement`` picks the routing
strategy (``single`` / ``static-hash`` / ``least-loaded`` /
``replica-affinity``; ``all`` sweeps every strategy valid for the shard
count).  ``--fleet-outage-at T`` (with ``--fleet-outage-shard I``) injects a
:class:`~repro_torch.serving.faults.ShardOutage`: shard ``I`` goes dark at
``T`` and its orphaned requests re-route to surviving replicas.  The
federation configuration rides the
:class:`~repro_torch.core.ExecutionContext` as
:class:`~repro_torch.core.FleetOptions`.

Every emitted schedule is validated by the simulator oracle
(:func:`repro_torch.core.verify.verify_schedule`): the discrete-event replay
recomputes the schedule's cost and must match the solver's exactly.  The
printed tables end each row with its wall time in parentheses; everything
else in them is exact and deterministic given ``--tape-seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

from ..core.context import BACKENDS, ComputeBudget
from ..core.solver import ExecutionContext, list_selectors, list_solvers


def _device_context(args) -> dict:
    """The context fields the tape flags choose: backend and device, with
    exact float64 tables for instances past the int32 guard."""
    return dict(backend=args.tape_backend, device=args.tape_device, numeric_policy="f64")


def _restore_from_tape(params, policy: str, context: dict) -> None:
    """Archive ``params`` to a simulated tape library and plan the restore.

    The library context owns a :class:`~repro_torch.core.SolveCache`, so
    the re-plan a recovering serving fleet issues for the *same* archive
    never re-solves a tape: the second pass below is all cache hits and its
    time is the pure memo-lookup cost.  The plan runs on ``context``'s
    backend and device, with no fallback.
    """
    from ..core.solver import SolveCache
    from ..distributed.checkpoint import archive_to_tape, plan_restore
    from ..storage.tape import TapeLibrary

    ctx = ExecutionContext(**context, cache=SolveCache())
    lib = TapeLibrary(capacity_per_tape=4 * 10**6, u_turn=20_000, context=ctx)
    shards = archive_to_tape(lib, "serve-warmup", params, bytes_per_elem=1)
    consumers = {s: 2 for s in shards}  # every host group needs every shard
    t0 = time.time()
    plans = plan_restore(lib, shards, consumers, policy=policy)
    dt = time.time() - t0
    # warm re-plan: what the next cold start in the fleet pays
    t0 = time.time()
    plan_restore(lib, shards, consumers, policy=policy, context=ctx)
    dt_warm = time.time() - t0
    n_req = sum(consumers.values())
    mean = sum(p.total_cost for p in plans) / n_req
    last = max(max(p.service_time.values()) for p in plans)
    stats = ctx.cache.stats()
    print(
        f"tape restore [{policy}/{ctx.backend}]: {len(shards)} shards on "
        f"{len(lib.tapes)} tape(s), mean arrival {mean:.3g}, last {last:.3g} "
        f"(planned in {dt * 1e3:.0f} ms; re-plan {dt_warm * 1e3:.0f} ms, "
        f"cache {stats['hits']} hits / {stats['misses']} misses)"
    )


def _serve_lm(args) -> int:
    """Serve ``--arch`` on one device or a mesh: prefill, then greedy
    decoding."""
    import torch

    from ..configs import ARCHS, reduced
    from ..distributed.context import is_sharded, mesh_scope
    from ..distributed.sharding import cache_pspecs, dp_axes, param_pspecs, place, place_tree
    from ..models.model import check_device, init_cache, init_model
    from ..serving.serve import make_serve_step
    from .train import _auto_mesh, group_up, rank_device, start_process_group

    started = start_process_group(args.tape_device)
    try:
        mesh = _auto_mesh(args.mesh) if group_up() or args.mesh != "auto" else None
        cfg = ARCHS[args.arch]
        if args.reduced:
            cfg = reduced(cfg, periods=2)
            cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 32768))
        check_device(args.tape_device)
        device = rank_device(args.tape_device)
        max_len = args.prompt_len + args.new_tokens

        params = init_model(torch.Generator(device).manual_seed(0), cfg, device=device)
        if args.restore_from_tape:
            _restore_from_tape(params, args.tape_policy, _device_context(args))
        cache = init_cache(cfg, args.batch, max_len=max_len, device=device)
        serve = make_serve_step(cfg)
        prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                device=device, generator=torch.Generator(device).manual_seed(1))
        if mesh is not None:
            place_tree(params, param_pspecs(params), mesh)
            cache = place_tree(cache, cache_pspecs(cache, mesh), mesh)
            prompts = place(prompts, (dp_axes(mesh), None), mesh)
        with mesh_scope(mesh):
            for t in range(args.prompt_len - 1):  # teacher-forced prefill
                _, _, cache = serve(params, cache, prompts[:, t : t + 1], t)
            tok = prompts[:, -1:]
            t0 = time.time()
            outs = []
            for t in range(args.new_tokens):
                tok, _, cache = serve(params, cache, tok, args.prompt_len - 1 + t)
                outs.append(tok)
            tokens = torch.cat(outs, 1)
            first = (tokens.full_tensor() if is_sharded(tokens) else tokens)[0].cpu()
        dt = time.time() - t0  # the copy above waits for the last step
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(f"{cfg.arch_id}: {args.batch}x{args.new_tokens} tokens in {dt:.2f}s "
          f"({args.batch*args.new_tokens/dt:.0f} tok/s)")
    print("first sequence:", first[:16].tolist(), "...")
    return 0


def _export_obs(obs, args) -> None:
    """Write the observability exporters a run's flags asked for.

    JSONL + Chrome trace to ``--tape-trace-out`` (the Chrome file rides
    next to the span log at ``PATH + ".chrome.json"``), Prometheus text
    to ``--tape-metrics-out``.  Shared by the queue and fleet modes.
    """
    from ..obs.export import write_chrome_trace, write_prometheus, write_spans_jsonl

    if args.tape_trace_out:
        n = write_spans_jsonl(obs.tracer, args.tape_trace_out)
        chrome = args.tape_trace_out + ".chrome.json"
        write_chrome_trace(obs.tracer, chrome)
        print(f"trace: {n} span(s) -> {args.tape_trace_out} (+ {chrome})")
    if args.tape_metrics_out:
        write_prometheus(obs.metrics, args.tape_metrics_out)
        print(f"metrics -> {args.tape_metrics_out}")


def _serve_tape_queue(args) -> int:
    """Drive the online tape-serving subsystem on one arrival trace.

    The trace is either replayed from a recorded JSONL file
    (``--trace-file``), generated with deadline/class annotations
    (``--tape-tightness``), or the plain seeded Poisson-like trace; each
    requested admission policy serves it on a shared drive pool under the
    chosen mount scheduler, and the per-policy service-time table is
    printed (with deadline-miss columns when the trace carries deadlines).
    Every dispatched schedule passes the simulator oracle (see the module
    docstring); the run is bit-deterministic given ``--tape-seed`` (or the
    trace file).  Returns a shell exit code: nonzero iff ``--slo-target``
    is set and no swept admission met it.
    """
    from ..data.traces import (
        qos_poisson_trace,
        read_trace,
        records_of,
        to_requests,
        write_trace,
    )
    from ..serving.drives import DriveCosts, RetryPolicy
    from ..serving.faults import recover_server, seeded_fault_plan
    from ..serving.queue import ADMISSIONS, WINDOWED_ADMISSIONS, serve_trace
    from ..serving.sim import demo_library, poisson_trace

    def build_library():
        return demo_library(args.tape_seed, n_files=args.tape_files)

    qos = {}
    if args.trace_file:
        if args.tape_tightness is not None:
            print("--trace-file replays recorded deadlines; it cannot be "
                  "combined with --tape-tightness")
            return 2
        records = read_trace(args.trace_file)
        trace, qos = to_requests(records, build_library())
        source = args.trace_file
    elif args.tape_tightness is not None:
        records = qos_poisson_trace(
            build_library(),
            n_requests=args.tape_requests,
            mean_interarrival=args.tape_rate,
            seed=args.tape_seed,
            tightness=args.tape_tightness,
        )
        trace, qos = to_requests(records, build_library())
        source = f"generated (tightness {args.tape_tightness})"
    else:
        trace = poisson_trace(
            build_library(),
            n_requests=args.tape_requests,
            mean_interarrival=args.tape_rate,
            seed=args.tape_seed,
        )
        records = None  # only materialised if the trace is being recorded
        source = "generated (best-effort)"
    if args.record_trace:
        if records is None:
            records = records_of(trace)
        write_trace(args.record_trace, records)
        print(f"recorded {len(records)} trace record(s) -> {args.record_trace}")
    admissions = (
        list(ADMISSIONS) if args.tape_admission == "all" else [args.tape_admission]
    )
    if args.tape_journal and len(admissions) != 1:
        print("--tape-journal records exactly one run; pick a single "
              "--tape-admission")
        return 2
    obs = None
    if args.tape_trace_out or args.tape_metrics_out:
        if len(admissions) != 1:
            print("--tape-trace-out/--tape-metrics-out record exactly one "
                  "run; pick a single --tape-admission")
            return 2
        from ..obs import Observability

        obs = Observability.enabled()
    costs = DriveCosts(
        mount=args.tape_mount_cost,
        unmount=args.tape_unmount_cost,
        load_seek=args.tape_load_seek,
    )
    n_drives = args.tape_drives  # None = one per cartridge
    faults = None
    retry = None
    if args.tape_fault_profile != "off":
        pool_size = n_drives if n_drives else len(build_library().tapes)
        heavy = args.tape_fault_profile == "heavy"
        faults = seeded_fault_plan(
            build_library(), trace, seed=args.tape_seed, n_drives=pool_size,
            drive_failures=2 if heavy else 1,
            mount_faults=1,
            media_faults=1 if heavy else 0,
            solver_faults=2 if heavy else 0,
            backend=args.tape_backend,
        )
        # drop (typed FailedRequest rows) rather than raise: the table below
        # reports completion per admission instead of dying on the first run
        retry = RetryPolicy(max_attempts=args.tape_retries, on_exhausted="drop")
        print(
            f"fault profile {args.tape_fault_profile}: "
            f"{len(faults.drive_failures)} drive failure(s), "
            f"{len(faults.mount_faults)} mount fault(s), "
            f"{len(faults.media_faults)} media fault(s), "
            f"{len(faults.solver_faults)} solver fault(s); "
            f"{args.tape_retries} retr{'y' if args.tape_retries == 1 else 'ies'} "
            f"per fault site"
        )
    journal = None
    if args.tape_cache_file:
        from ..core.cache import JsonlCacheBackend

        journal = JsonlCacheBackend(args.tape_cache_file)
        print(
            f"persistent solve memo: {args.tape_cache_file} "
            f"({journal.loaded} journaled solve(s) replayed)"
        )
    print(
        f"online tape serving: {len(trace)} requests ({source}), "
        f"{len({r.tape_id for r in trace})} cartridge(s), "
        f"{n_drives if n_drives else 'dedicated'} drive(s), "
        f"scheduler {args.tape_scheduler}, policy {args.tape_policy}/"
        f"{args.tape_backend}, warm start "
        f"{'off' if args.no_tape_warm else 'on'}"
        + (f", selector {args.tape_selector}"
           f"{f' (budget {args.tape_budget} cells/tick)' if args.tape_budget else ''}"
           if args.tape_selector else "")
    )
    deadline_cols = ",missed,miss_rate" if qos else ""
    fault_cols = ",completed,failed,requeued" if faults is not None else ""
    selector_cols = ",policy_mix" if args.tape_selector else ""
    print("admission,window,mean_sojourn,p50_sojourn,p95_sojourn,batches,"
          f"preempts,mounts,cache_hits,cells,reused"
          f"{deadline_cols}{fault_cols}{selector_cols}")
    best_miss_rate = None
    for admission in admissions:
        lib = build_library()
        ctx = lib.context.replace(**_device_context(args))
        if obs is not None:
            ctx = ctx.replace(obs=obs)
        if journal is not None:
            ctx = ctx.replace(cache=journal)
        if args.tape_budget is not None:
            ctx = ctx.replace(budget=ComputeBudget(per_tick=args.tape_budget))
        common = dict(
            window=args.tape_window if admission in WINDOWED_ADMISSIONS else 0,
            policy=args.tape_policy,
            selector=args.tape_selector,
            n_drives=n_drives,
            drive_costs=costs,
            qos=qos or None,
            mount_scheduler=args.tape_scheduler,
            context=ctx,
            warm_start=not args.no_tape_warm,
            faults=faults,
            retry=retry,
        )
        t0 = time.time()
        if args.tape_journal and os.path.exists(args.tape_journal) \
                and os.path.getsize(args.tape_journal) > 0:
            report = recover_server(
                lib, trace, args.tape_journal, admission=admission, **common
            )
            print(f"recovered from journal {args.tape_journal}")
        else:
            report = serve_trace(
                lib, trace, admission, journal=args.tape_journal, **common
            )
        dt = time.time() - t0
        s = report.summary()  # oracle runs per dispatch: a failure raised above
        extra = ""
        if qos:
            extra = f",{s['n_missed']}/{s['n_deadlines']},{s['miss_rate']:.3f}"
            best_miss_rate = (
                s["miss_rate"]
                if best_miss_rate is None
                else min(best_miss_rate, s["miss_rate"])
            )
        if faults is not None:
            extra += (
                f",{report.n_served}/{len(trace)},{report.n_failed},"
                f"{s['faults']['requeued']}"
            )
        if args.tape_selector:
            extra += "," + "+".join(
                f"{p}:{n}" for p, n in sorted(s["policy_mix"].items())
            )
        print(
            f"{admission},{s['window']},{s['mean_sojourn']:.4g},"
            f"{s['p50_sojourn']:.4g},{s['p95_sojourn']:.4g},{s['n_batches']},"
            f"{s['n_preemptions']},{s['mounts']},{s['cache']['hits']},"
            f"{s['cells_evaluated']},{s['cells_reused']}{extra} "
            f"({dt*1e3:.0f} ms wall)"
        )
    if journal is not None:
        journal.close()
    if obs is not None:
        _export_obs(obs, args)
    if args.slo_target is not None:
        if not any(s.deadline is not None for s in qos.values()):
            print("--slo-target needs a deadline-annotated trace "
                  "(--tape-tightness or --trace-file with deadlines)")
            return 2
        ok = best_miss_rate is not None and best_miss_rate <= args.slo_target
        print(
            f"SLO {'PASS' if ok else 'FAIL'}: best miss rate "
            f"{best_miss_rate:.3f} vs target {args.slo_target:.3f}"
        )
        return 0 if ok else 1
    return 0


def _serve_tape_fleet(args) -> int:
    """Drive the fleet federation on one federation-wide arrival trace.

    Builds a seeded ``--fleet-shards``-shard archive with
    ``--fleet-replicas``-way replication, generates one trace over the
    unified catalogue, and serves it under each requested placement
    strategy (fresh shard libraries per run, so runs never share state).
    The federation configuration rides the
    :class:`~repro_torch.core.ExecutionContext` as
    :class:`~repro_torch.core.FleetOptions` — ``serve_fleet_trace`` reads the
    placement from there.  Deterministic given ``--tape-seed``.
    """
    from ..core.context import FleetOptions
    from ..core.solver import SolveCache
    from ..data.traces import qos_poisson_trace, to_requests
    from ..fleet import demo_fleet, fleet_catalog, serve_fleet_trace
    from ..serving.drives import DriveCosts, RetryPolicy
    from ..serving.faults import ShardOutage
    from ..serving.queue import WINDOWED_ADMISSIONS
    from ..serving.sim import poisson_trace

    n_shards = args.fleet_shards
    if n_shards < 1:
        print("--fleet-shards must be >= 1")
        return 2
    if not (1 <= args.fleet_replicas <= n_shards):
        print("--fleet-replicas must be between 1 and --fleet-shards")
        return 2
    if args.fleet_placement == "all":
        placements = (
            ["single"]
            if n_shards == 1
            else ["static-hash", "least-loaded", "replica-affinity"]
        )
    else:
        placements = [args.fleet_placement]
    if "single" in placements and n_shards != 1:
        print("placement 'single' is the one-shard NoOp default; pick a "
              "routing strategy (or --fleet-shards 1)")
        return 2
    obs = None
    if args.tape_trace_out or args.tape_metrics_out:
        if len(placements) != 1:
            print("--tape-trace-out/--tape-metrics-out record exactly one "
                  "run; pick a single --fleet-placement")
            return 2
        from ..obs import Observability

        obs = Observability.enabled()

    def build_fleet():
        return demo_fleet(
            args.tape_seed,
            n_shards=n_shards,
            n_files=args.tape_files,
            replicas=args.fleet_replicas,
            with_cache=False,  # the run's shared memo lives on the context
        )

    libs, rmap = build_fleet()
    catalog = fleet_catalog(libs, rmap)
    qos = {}
    if args.tape_tightness is not None:
        records = qos_poisson_trace(
            catalog,
            n_requests=args.tape_requests,
            mean_interarrival=args.tape_rate,
            seed=args.tape_seed,
            tightness=args.tape_tightness,
        )
        trace, qos = to_requests(records)
    else:
        trace = poisson_trace(
            catalog,
            n_requests=args.tape_requests,
            mean_interarrival=args.tape_rate,
            seed=args.tape_seed,
        )
    outages = ()
    retry = None
    if args.fleet_outage_at is not None:
        if not (0 <= args.fleet_outage_shard < n_shards):
            print("--fleet-outage-shard must name a shard in the fleet")
            return 2
        outages = (ShardOutage(at=args.fleet_outage_at,
                               shard=args.fleet_outage_shard),)
        # drop (typed FailedRequest rows) rather than raise when a dark
        # shard strands replicas-of-one requests: the table compares
        # placements on completion instead of dying on the first run
        retry = RetryPolicy(on_exhausted="drop")
    admission = (
        "accumulate" if args.tape_admission == "all" else args.tape_admission
    )
    costs = DriveCosts(
        mount=args.tape_mount_cost,
        unmount=args.tape_unmount_cost,
        load_seek=args.tape_load_seek,
    )
    print(
        f"fleet serving: {n_shards} shard(s) x "
        f"{args.tape_drives if args.tape_drives else 'dedicated'} drive(s), "
        f"{args.fleet_replicas}-way replicas, {len(trace)} requests, "
        f"admission {admission}, policy {args.tape_policy}/{args.tape_backend}"
        + (f", outage: shard {args.fleet_outage_shard} at "
           f"{args.fleet_outage_at}" if outages else "")
    )
    deadline_cols = ",missed,miss_rate" if qos else ""
    print(f"placement,served,failed,rerouted,mean_sojourn,p95_sojourn,"
          f"mounts{deadline_cols}")
    for pl in placements:
        libs, rmap = build_fleet()
        ctx = ExecutionContext(
            **_device_context(args),
            cache=SolveCache(),
            fleet=FleetOptions(
                n_shards=n_shards, placement=pl, replicas=args.fleet_replicas
            ),
            obs=obs,
        )
        t0 = time.time()
        fr = serve_fleet_trace(
            libs,
            trace,
            admission,
            replica_map=rmap,
            outages=outages,
            window=(
                args.tape_window if admission in WINDOWED_ADMISSIONS else 0
            ),
            policy=args.tape_policy,
            n_drives=args.tape_drives,
            drive_costs=costs,
            qos=qos or None,
            context=ctx,
            warm_start=not args.no_tape_warm,
            retry=retry,
        )
        dt = time.time() - t0
        s = fr.summary()
        extra = ""
        if qos:
            extra = f",{s['n_missed']}/{s['n_deadlines']},{s['miss_rate']:.3f}"
        print(
            f"{pl},{fr.n_served}/{len(trace)},{fr.n_failed},{fr.n_rerouted},"
            f"{s['mean_sojourn']:.4g},{s['p95_sojourn']:.4g},{s['mounts']}"
            f"{extra} ({dt*1e3:.0f} ms wall; routes "
            + "/".join(str(fr.routes[i]) for i in range(n_shards))
            + ")"
        )
    if obs is not None:
        _export_obs(obs, args)
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The reference launcher's flags, plus ``--tape-device``."""
    from ..configs import ARCHS
    from ..serving.drives import MOUNT_SCHEDULERS
    from ..serving.queue import ADMISSIONS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--mesh", default="auto", choices=["auto", "pod", "multipod"],
                    help="device mesh of the model: 'auto' the largest (data, model) grid "
                         "over the process group's ranks (one device without a group); "
                         "'pod' 16x16, 'multipod' 2x16x16")
    ap.add_argument("--restore-from-tape", action="store_true",
                    help="simulate an LTSP-scheduled checkpoint restore first")
    ap.add_argument("--tape-policy", default="dp", choices=list_solvers())
    ap.add_argument("--tape-backend", default="cuda", choices=list(BACKENDS),
                    help="solver backend: 'cuda' (the CUDA kernels, default), "
                         "'torch' (their plain version) or 'python' (exact host DP)")
    ap.add_argument("--tape-device", default="cuda",
                    help="torch device of the model and of the 'cuda' and 'torch' "
                         "backends ('cpu' runs both without a card)")
    ap.add_argument("--serve-tape-queue", action="store_true",
                    help="run the online tape-serving queue simulation "
                         "(admission-policy comparison)")
    ap.add_argument("--tape-admission", default="all",
                    choices=[*ADMISSIONS, "all"])
    ap.add_argument("--serve-tape-fleet", action="store_true",
                    help="run the sharded fleet-federation simulation "
                         "(placement-strategy comparison)")
    ap.add_argument("--fleet-shards", type=int, default=3, metavar="N",
                    help="per-library shards in the federation")
    ap.add_argument("--fleet-placement", default="all",
                    choices=["single", "static-hash", "least-loaded",
                             "replica-affinity", "all"],
                    help="replica routing strategy ('all' sweeps every "
                         "strategy valid for the shard count)")
    ap.add_argument("--fleet-replicas", type=int, default=2, metavar="K",
                    help="shards each logical file is replicated on")
    ap.add_argument("--fleet-outage-at", type=int, default=None, metavar="T",
                    help="inject a ShardOutage (whole shard dark) at this "
                         "virtual time")
    ap.add_argument("--fleet-outage-shard", type=int, default=0, metavar="I",
                    help="shard the injected outage darkens")
    ap.add_argument("--tape-selector", default=None,
                    choices=list_selectors(),
                    help="load-adaptive solver selection: re-pick the solve "
                         "policy each tick from queue depth / recorded solve "
                         "timings (unset = pin --tape-policy)")
    ap.add_argument("--tape-budget", type=int, default=None, metavar="CELLS",
                    help="per-tick DP cell budget the 'cost-model' selector "
                         "fits under (repro_torch.core.ComputeBudget.per_tick)")
    ap.add_argument("--tape-scheduler", default="greedy",
                    choices=sorted(MOUNT_SCHEDULERS),
                    help="drive-pool mount/eviction scheduler")
    ap.add_argument("--trace-file", default=None, metavar="PATH",
                    help="replay a recorded JSONL trace (repro_torch.data.traces) "
                         "instead of generating one")
    ap.add_argument("--record-trace", default=None, metavar="PATH",
                    help="write the served trace as JSONL (round-trips "
                         "bit-exactly through --trace-file)")
    ap.add_argument("--tape-tightness", type=int, default=None,
                    help="annotate the generated trace with deadlines: "
                         "deadline = arrival + tightness * class slack "
                         "multiplier (enables the QoS admissions)")
    ap.add_argument("--slo-target", type=float, default=None, metavar="RATE",
                    help="deadline-miss-rate target; exit 1 unless some "
                         "swept admission meets it")
    ap.add_argument("--no-tape-warm", action="store_true",
                    help="disable warm-started re-solves (bit-identical "
                         "schedules either way; cold re-solves every tick)")
    ap.add_argument("--tape-cache-file", default=None, metavar="PATH",
                    help="persist the solve memo to a JSONL journal "
                         "(replayed on the next run against the same path)")
    ap.add_argument("--tape-fault-profile", default="off",
                    choices=["off", "light", "heavy"],
                    help="inject a seeded fault plan into the serving run: "
                         "'light' = 1 drive failure + 1 transient mount "
                         "fault, 'heavy' adds media + solver faults "
                         "(deterministic given --tape-seed)")
    ap.add_argument("--tape-retries", type=int, default=3, metavar="N",
                    help="retry budget per fault site (mount attempts, media "
                         "read attempts, solver attempts per backend tier); "
                         "exhausted budgets drop requests as typed failures")
    ap.add_argument("--tape-trace-out", default=None, metavar="PATH",
                    help="attach the observability tracer and export the "
                         "virtual-time span log as JSONL at PATH plus a "
                         "Chrome trace_event file at PATH + '.chrome.json' "
                         "(single-admission/-placement runs only)")
    ap.add_argument("--tape-metrics-out", default=None, metavar="PATH",
                    help="attach the observability metrics registry and "
                         "export a Prometheus text snapshot at PATH "
                         "(single-admission/-placement runs only)")
    ap.add_argument("--tape-journal", default=None, metavar="PATH",
                    help="write-ahead event journal; if PATH already holds a "
                         "(possibly torn) journal from a crashed run, the "
                         "run recovers from it bit-identically")
    ap.add_argument("--tape-window", type=int, default=400_000,
                    help="accumulate-then-solve re-plan window (virtual time)")
    ap.add_argument("--tape-drives", type=int, default=None,
                    help="shared drive-pool size (default: one per cartridge)")
    ap.add_argument("--tape-mount-cost", type=int, default=0,
                    help="cost of threading a cartridge into a drive")
    ap.add_argument("--tape-unmount-cost", type=int, default=0,
                    help="cost of ejecting the cartridge a drive holds")
    ap.add_argument("--tape-load-seek", type=int, default=0,
                    help="seek from thread point to load point after mounting")
    ap.add_argument("--tape-rate", type=int, default=250_000,
                    help="mean request inter-arrival time (virtual time)")
    ap.add_argument("--tape-requests", type=int, default=300)
    ap.add_argument("--tape-files", type=int, default=40)
    ap.add_argument("--tape-seed", type=int, default=20260731)
    return ap


def main(argv=None) -> int:
    """Run the launcher on ``argv`` (default: the command line); returns the
    exit status."""
    args = build_parser().parse_args(argv)

    if args.serve_tape_queue:
        return _serve_tape_queue(args)
    if args.serve_tape_fleet:
        return _serve_tape_fleet(args)
    return _serve_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
