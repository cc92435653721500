"""The CNN trainer's command line (counterpart of the JAX package's
`train/cli.py`): the same flags, per-epoch lines, phase report, phase log
files and final ``SUMMARY {json}`` line.

    python -m distributed_neural_network_tpu_torch.train.cli --regime data_parallel \\
        --nb-proc 4 --epochs 2 --kernels cuda

Runs on the GPU unless ``--device cpu`` is given. ``--kernels torch`` (the
default, as ``xla`` is the JAX default) runs the classifier head as plain
PyTorch ops; ``--kernels cuda`` runs it as the hand-written fused CUDA kernel
(the JAX package's ``pallas``). ``--input-mode stream`` keeps the train split
in host RAM and streams its batches (``--stream-prefetch`` steps ahead);
``--compute-dtype bfloat16`` runs the convolutions in bf16. Flags whose
feature this port has not reached yet are accepted and raise
`NotImplementedError` naming the item that brings them.

Checkpoints and telemetry, as the JAX CLI's: ``--checkpoint-dir D`` saves
the engine's state every ``--checkpoint-every`` epochs (the last
``--checkpoint-keep``; `utils/checkpoint.py`, the JAX npz layout) and
``--resume`` continues from the newest one bit for bit; ``--on-sigterm
checkpoint`` (the default) turns SIGTERM / SIGINT into an emergency
checkpoint at the next epoch boundary and a clean exit. ``--trace-out``
writes a Chrome trace (`utils/tracing.py`; per rank ``*_rank{r}.json``
under torchrun, merged by `tools/trace_merge.py`), ``--step-stats`` prints
the StepStats summary and streams ``step/*`` series into
``--metrics-jsonl``, ``--run-record`` writes the goodput run record
(`utils/goodput.py`, read by `tools/goodput.py`); the GOODPUT line is
printed either way.

The per-epoch training guard, as the JAX CLI's (`train/guard.py`): ``--guard
warn|skip|rollback|abort`` observes each epoch's global train loss (the
per-epoch path: a ``--fused`` span cannot be observed inside it);
``--guard-spike-zscore``, ``--snapshot-every`` (epochs between the rolling
host snapshots) and ``--max-retries`` as the JAX flags.

Across processes, one per rank under torchrun, which sets the rendezvous
environment (`parallel/distributed.py`):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m distributed_neural_network_tpu_torch.train.cli --nb-proc 4 ...

The ``--nb-proc`` workers split evenly over the ranks. Every rank prints its
lines and its SUMMARY (the metrics are the same on every rank); ranks above
0 write their phase logs and metrics JSONL under ``_rank{r}`` names.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import torch
import torch.distributed as dist

from ..data.cifar10 import load_split
from ..device import resolve_device
from ..ops import fused_head
from ..parallel.distributed import initialize, joined, rank_device
from ..utils import timers as T
from ..utils import tracing as TR
from ..utils.goodput import LEDGER, RUN_RECORD_ENV
from ..utils.logfiles import write_phase_logs
from ..utils.metrics import init_run
from .engine import SLICE4, Engine, TrainConfig
from .guard import POLICIES, GuardAbort, GuardConfig, PreemptionGuard, TrainingGuard

SLICE5 = "slice 5, static analysis (ROADMAP.md Queue 1 item 6)"

# dest -> (flag, the slice that brings it); each is parsed with default None
LATER_FLAGS = {
    "elastic": ("--elastic", SLICE4),
    "metrics_port": ("--metrics-port", SLICE4),
    "profile_dir": ("--profile-dir", SLICE4),
    "neptune": ("--neptune", SLICE4),
}


def add_common_flags(p: argparse.ArgumentParser, *, epochs: int, batch_size: int):
    p.add_argument("--lr", dest="lr", type=float, default=0.001)
    p.add_argument("--momentum", dest="momentum", type=float, default=0.9)
    p.add_argument("--batch-size", dest="bs", type=int, default=batch_size)
    p.add_argument("--epochs", dest="epochs", type=int, default=epochs)
    p.add_argument("--seed", type=int, default=0, help="seed of init, shuffle and faults")
    p.add_argument(
        "--device", default="cuda",
        help="cuda (default) or cpu; asking for cuda without a GPU is an error",
    )
    p.add_argument(
        "--sync-mode", choices=("epoch", "step"), default="epoch",
        help="epoch = faithful local SGD + epoch-edge parameter averaging; "
        "step = per-step gradient mean over the workers",
    )
    p.add_argument(
        "--no-momentum-reset", action="store_true",
        help="keep momentum across epochs (reference re-creates SGD per epoch)",
    )
    p.add_argument(
        "--grad-sync", choices=("end", "overlap"), default="end",
        help="per-step gradient-sync granularity under --sync-mode step: end = one "
        "collective for every gradient; overlap = one per size-capped leaf bucket "
        "(--bucket-mb); the same values either way (no effect in epoch mode)",
    )
    p.add_argument("--bucket-mb", type=float, default=4.0,
                   help="gradient-bucket payload cap in MiB for --grad-sync overlap")
    p.add_argument(
        "--precision", choices=("bf16", "fp8", "int8", "int8-kv"), default="bf16",
        help="only bf16 (the full-precision contract) runs the CNN trainer",
    )
    p.add_argument(
        "--input-mode", choices=("hbm", "stream"), default="hbm",
        help="hbm = the split uploaded to device memory once (default); stream = the "
        "train split stays in host RAM (uint8), each step's batch assembled by the "
        "native C++ kernel and copied to the card",
    )
    p.add_argument(
        "--stream-prefetch", type=int, default=2,
        help="stream mode: batches assembled this many steps ahead on a background "
        "thread (2 = double buffering, 0 = synchronous)",
    )
    p.add_argument("--data", choices=("auto", "pickle", "npz", "synthetic"), default="auto")
    p.add_argument("--data-root", default=None, help="dataset dir (default ./data)")
    p.add_argument(
        "--synthetic-size", type=int, default=None,
        help="synthetic train rows (test = 1/5 of it); default: CIFAR-10 sizes",
    )
    p.add_argument("--log-dir", default="log", help="phase-time log directory")
    p.add_argument("--metrics-jsonl", default=None, help="metrics JSONL path")
    p.add_argument("--eval-batch-size", type=int, default=None)
    p.add_argument(
        "--compute-dtype", choices=("float32", "bfloat16"), default="float32",
        help="bfloat16 = the convolutions in bf16 (parameters, momentum and loss stay "
        "float32; the --kernels cuda head takes float32)",
    )
    p.add_argument(
        "--kernels", choices=("torch", "cuda"), default="torch",
        help="cuda = the hand-written fused classifier-head kernel "
        "(JAX: pallas); torch = plain PyTorch ops (JAX: xla)",
    )
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument(
        "--fused",
        action="store_true",
        help="run multi-epoch spans (train, masked sync and eval replayed from "
        "the captured CUDA graphs with no host read between epochs) instead "
        "of one read per epoch; phase timing then reports "
        "train+sync(+eval at --eval-every 1) as one TRAINING number. "
        "Downgraded, with a line saying so, to the per-epoch path when "
        "combined with --failure-duration > 0 (straggler sleeps can only "
        "interleave between epochs) or --input-mode stream",
    )
    p.add_argument("--dynamics", action="store_true")
    p.add_argument(
        "--run-record", default=None, metavar="RECORD.json",
        help="write the goodput run record here (utils/goodput.py: goodput ratio + per-cause "
        "badput seconds; written through during the run; render/diff/gate with "
        f"tools/goodput.py). Defaults to the {RUN_RECORD_ENV} environment variable; a "
        "GOODPUT summary line is printed either way",
    )
    p.add_argument("--checkpoint-dir", default=None,
                   help="save params+momentum+history at epoch edges")
    p.add_argument("--checkpoint-every", type=int, default=1, help="epochs between saves")
    p.add_argument("--checkpoint-keep", type=int, default=3, help="checkpoints retained")
    p.add_argument("--checkpoint-backend", choices=("auto", "orbax", "npz"), default="auto",
                   help="auto = npz (the JAX package's npz layout); orbax is not available "
                   "to the port")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint-dir")
    p.add_argument(
        "--on-sigterm", choices=("checkpoint", "ignore"), default="checkpoint",
        help="checkpoint = on SIGTERM/SIGINT finish the current epoch, write an emergency "
        "checkpoint (when --checkpoint-dir is set) and exit cleanly for exact resume; "
        "ignore = default signal behavior",
    )
    p.add_argument(
        "--guard", choices=POLICIES, default="off",
        help="per-epoch training guard: warn = count/log anomalies (non-finite loss, EMA loss "
        "spikes); skip = drop an anomalous epoch's update (pre-epoch snapshot restored); "
        "rollback = restore the rolling snapshot and retry with LR backoff (bounded by "
        "--max-retries); abort = stop with an actionable error",
    )
    p.add_argument(
        "--guard-spike-zscore", type=float, default=6.0,
        help="loss-spike threshold in EMA standard deviations (anomaly when loss > mean + "
        "z*sigma; non-finite always counts)",
    )
    p.add_argument(
        "--snapshot-every", type=int, default=1,
        help="epochs between the guard's rolling in-memory host snapshots (a rollback "
        "rewinds at most this far)",
    )
    p.add_argument(
        "--max-retries", type=int, default=3,
        help="guard rollback budget before abort (refills after a stretch of healthy epochs)",
    )
    p.add_argument(
        "--trace-out", default=None, metavar="TRACE.json",
        help="write a Chrome trace-event JSON of the run (span per train_step/sync/eval, one "
        "track per phase) - open in Perfetto or chrome://tracing, summarize with "
        "tools/trace_summary.py",
    )
    p.add_argument(
        "--step-stats", action="store_true",
        help="collect per-step StepStats (compile vs steady-state step time, images/s, device "
        "memory, collective bytes, MFU), print the summary, and emit step/* series to "
        "--metrics-jsonl",
    )
    for dest, (flag, later) in LATER_FLAGS.items():
        p.add_argument(flag, dest=dest, nargs="?", const=True, default=None,
                       help=f"not ported yet: {later}")
    return p


def add_distributed_flags(p: argparse.ArgumentParser, *, nb_proc: int | None = 4):
    p.add_argument(
        "--nb-proc", dest="nb_proc", type=int, default=nb_proc,
        help="number of workers in the replica group (reference: MPI world size)",
    )
    p.add_argument(
        "--failure-probability", dest="failure_probability", type=float, default=0.0,
        help="Probability of simulated process failure at each epoch",
    )
    p.add_argument(
        "--failure-duration", dest="failure_duration", type=float, default=0.0,
        help="Duration of simulated process failure in seconds",
    )
    p.add_argument(
        "--reference-compat", action="store_true",
        help="N-1 compute workers at --nb-proc N, as the reference's idle-parent topology",
    )
    p.add_argument("--sharding", choices=("manual", "auto"), default="manual",
                   help=f"auto is not ported yet: {SLICE5}")
    return p


def config_from_args(args, regime: str) -> TrainConfig:
    return TrainConfig(
        lr=args.lr,
        momentum=args.momentum,
        batch_size=args.bs,
        epochs=args.epochs,
        nb_proc=getattr(args, "nb_proc", None),
        regime=regime,
        sync_mode=args.sync_mode,
        reset_momentum=not args.no_momentum_reset,
        failure_probability=getattr(args, "failure_probability", 0.0),
        failure_duration=getattr(args, "failure_duration", 0.0),
        seed=args.seed,
        eval_batch_size=args.eval_batch_size,
        kernels=args.kernels,
        reference_compat=getattr(args, "reference_compat", False),
        input_mode=args.input_mode,
        stream_prefetch=args.stream_prefetch,
        grad_sync=args.grad_sync,
        bucket_mb=args.bucket_mb,
        compute_dtype=args.compute_dtype,
        dynamics=args.dynamics,
    )


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag whose feature is not ported yet."""
    for dest, (flag, later) in LATER_FLAGS.items():
        if getattr(args, dest, None) is not None:
            raise NotImplementedError(f"{flag} is not ported yet; it comes with {later}")
    if getattr(args, "sharding", "manual") == "auto":
        raise NotImplementedError(f"--sharding auto is not ported yet; it comes with {SLICE5}")
    if args.precision != "bf16":
        raise SystemExit(
            f"--precision {args.precision}: the CNN trainer has no quantized "
            "kernels (its conv/dense math is full precision)"
        )


def say(line: str) -> None:
    """Print `line` and its newline in one write. The ranks that torchrun
    starts share its stdout; `print` writes the newline on its own, so
    another rank's line could land between a line and its end."""
    sys.stdout.write(f"{line}\n")
    sys.stdout.flush()


def run_training(args, regime: str, *, log=say) -> Engine:
    """Join the process group if torchrun started this process, load data,
    train (resuming and checkpointing as asked), write phase logs and the
    trace, and print the GOODPUT and SUMMARY lines."""
    check_ported(args)
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    # the goodput wall clock starts before the rendezvous and the data load
    # (the init bucket holds them); one ledger per run
    LEDGER.reset()
    LEDGER.start()
    record = args.run_record or os.environ.get(RUN_RECORD_ENV)
    if record:
        LEDGER.arm(record)
    cfg = config_from_args(args, regime)
    device = resolve_device(args.device)
    rank = None
    # before anything touches the card: it picks the rank's card and backend
    if initialize(device=device, log=log):
        device, rank = rank_device(device), dist.get_rank()
        log(f"(Multi-process: rank {rank}/{dist.get_world_size()}, backend "
            f"{dist.get_backend()}, device {device})")
    LEDGER.rank = rank
    tracer = TR.Tracer(enabled=bool(args.trace_out))
    trace_out = args.trace_out
    if rank is not None:
        # rank-stamped process lanes and one trace shard per rank
        tracer.set_process(rank=rank, hostname=socket.gethostname())
        if trace_out:
            trace_out = TR.rank_trace_path(trace_out, rank)
            log(f"(per-rank trace shard: {trace_out})")
    preemption = None
    if args.on_sigterm == "checkpoint":
        preemption = PreemptionGuard(log=log).install()
    try:
        return _run_training_body(args, regime, log=log, cfg=cfg, device=device, rank=rank,
                                  tracer=tracer, trace_out=trace_out, preemption=preemption)
    finally:
        if preemption is not None:
            preemption.uninstall()


def _run_training_body(args, regime, *, log, cfg, device, rank, tracer, trace_out,
                       preemption) -> Engine:
    timers = T.PhaseTimers(device)
    syn = args.synthetic_size
    with tracer.span(TR.DATA_LOADING, track="host"), timers.phase(T.DATA_LOADING):
        train_split = load_split(
            True, root=args.data_root, source=args.data, seed=args.seed,
            synthetic_size=syn,
            # streaming keeps the train split uint8 in host RAM; the native
            # kernel normalizes each batch
            normalize_images=cfg.input_mode != "stream",
        )
        test_split = load_split(
            False, root=args.data_root, source=args.data, seed=args.seed,
            synthetic_size=max(1, syn // 5) if syn else None,
        )
    log(
        f"(Loaded train dataset of length {len(train_split)} "
        f"[source={train_split.source}], test length {len(test_split)})"
    )

    run = init_run(jsonl_path=args.metrics_jsonl, rank=rank)
    run["parameters"] = {
        "learning_rate": cfg.lr,
        "optimizer": "SGD",
        "model_name": {"single": "nodistmodel"}.get(regime, "distmodel"),
        "epochs": cfg.epochs,
        "batch_size": cfg.batch_size,
        "regime": regime,
        "sync_mode": cfg.sync_mode,
        "nb_proc": cfg.nb_proc,
        "seed": cfg.seed,
        "input_mode": cfg.input_mode,
        "compute_dtype": cfg.compute_dtype,
    }

    t0 = time.perf_counter()
    engine = Engine(cfg, train_split, test_split, device=device, tracer=tracer)
    LEDGER.describe(
        config={
            "regime": regime, "epochs": cfg.epochs, "batch_size": cfg.batch_size,
            "lr": cfg.lr, "nb_proc": cfg.nb_proc, "sync_mode": cfg.sync_mode,
            "seed": cfg.seed, "compute_dtype": cfg.compute_dtype,
            "input_mode": cfg.input_mode, "kernels": cfg.kernels,
        },
        mesh={"axes": {"data": engine.n_workers}, "devices": engine.mesh.world,
              "desc": f"data{engine.n_workers}", "optimizer": "sgd"},
    )
    stats = None
    if args.step_stats or trace_out:
        from .measure import peak_flops

        flops, flops_src = engine.flops_per_epoch()
        # one worker's parameters, detached: a view that tracks gradients would
        # keep the parameters' AccumulateGrad nodes alive into the capture
        one = [p[0].detach() for p in engine.params]
        kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        stats = TR.StepStats(
            item_label="images",
            # step/* series ride the metrics sink; without --step-stats the
            # trace still embeds the summary
            sink=run if args.step_stats else None,
            n_devices=engine.mesh.world,
            comm_bytes_per_step=TR.collective_bytes_per_sync(one, engine.n_workers),
            flops_per_step=flops,
            flops_source=flops_src,
            peak_flops_per_device=peak_flops(kind, cfg.compute_dtype),
            grad_sync=cfg.grad_sync if cfg.sync_mode == "step" else None,
        )
        engine.step_stats = stats
        if cfg.sync_mode == "step" and cfg.grad_sync == "overlap":
            # the bucket plan in-band in the trace (the collectives run
            # inside the captured step, where no span sees them)
            from ..parallel.collectives import plan_buckets

            layout = plan_buckets(one, bucket_bytes=int(cfg.bucket_mb * 2**20))
            stats.comm_bucket_bytes = [int(b) for b in layout.bucket_bytes()]
            TR.record_bucket_plan(tracer, stats.comm_bucket_bytes, schedule="overlap",
                                  op="pmean", axis_size=engine.n_workers)

    checkpointer = None
    start_epoch = 0
    if args.checkpoint_dir:
        from ..utils.checkpoint import Checkpointer

        checkpointer = Checkpointer(args.checkpoint_dir, every=args.checkpoint_every,
                                    keep=args.checkpoint_keep,
                                    backend=args.checkpoint_backend)
        if args.resume:
            start_epoch = checkpointer.restore_latest(engine, log=log)
            if start_epoch:
                secs, nbytes = checkpointer.last_restore
                log(f"(Resumed from checkpoint: next epoch {start_epoch}; read {nbytes:,} B "
                    f"in {secs:.3f} s)")
            else:
                log(
                    f"(WARNING: --resume found no checkpoint in "
                    f"{args.checkpoint_dir} [backend={checkpointer.backend_name}]; "
                    "starting from scratch - check the dir and "
                    "--checkpoint-backend match the original run)"
                )
    # the per-epoch policy guard; the preemption guard was installed by
    # run_training
    guard = None
    if args.guard != "off":
        guard = TrainingGuard(
            GuardConfig(policy=args.guard, spike_zscore=args.guard_spike_zscore,
                        snapshot_every=args.snapshot_every, max_retries=args.max_retries,
                        # one observation an epoch: arm the spike detector
                        # after a few epochs rather than the step-scale default
                        warmup_steps=3),
            tracer=tracer, step_stats=stats, log=log)
    try:
        engine.run(timers=timers, run=run, log=log, eval_every=args.eval_every,
                   fused=args.fused, checkpointer=checkpointer, start_epoch=start_epoch,
                   preemption=preemption, guard=guard)
    finally:
        if checkpointer is not None:
            checkpointer.close()
    wall = time.perf_counter() - t0
    if guard is not None:
        log(f"(guard summary: {json.dumps(guard.summary())})")
    if checkpointer is not None and checkpointer.last_save is not None:
        secs, nbytes = checkpointer.last_save
        log(f"(Last checkpoint: {nbytes:,} B written in {secs:.3f} s)")
    preempted = bool(preemption.requested) if preemption else False

    # goodput close-out: the conservation-checked breakdown and the run record
    goodput_rec = LEDGER.finalize(metrics={
        "final_train_loss": engine.history[-1].train_loss if engine.history else None,
        "final_val_acc": engine.history[-1].val_acc if engine.history else None,
        "epochs": cfg.epochs,
        "preempted": preempted,
    })
    log("GOODPUT " + json.dumps({
        "goodput_ratio": goodput_rec["goodput_ratio"],
        "wall_s": goodput_rec["wall_s"],
        "goodput_s": goodput_rec["goodput_s"],
        "badput_s": {k: v for k, v in goodput_rec["badput_s"].items() if v > 0},
        "steps": goodput_rec["steps"],
        "record": LEDGER.path,
    }))
    if stats is not None and args.step_stats:
        for line in stats.report().splitlines():
            log(line)
    if trace_out:
        tracer.export(trace_out, step_stats=stats, goodput=goodput_rec)
        log(f"(Chrome trace written to {trace_out}; open in Perfetto / chrome://tracing, or "
            "summarize with tools/trace_summary.py)")
    run.stop()

    for line in timers.report().splitlines():
        log(line)
    log(f"Total wall-clock: {wall:.3f} s")

    if args.log_dir:
        parent, children = write_phase_logs(
            args.log_dir,
            bs=cfg.batch_size,
            epochs=cfg.epochs,
            nb_proc=getattr(args, "nb_proc", None) or 1,
            timers=timers,
            rank=rank,
        )
        log(f"(Phase logs written: {parent}, {children})")

    best = max(
        (m for m in engine.history if m.val_acc is not None),
        key=lambda m: m.val_acc,
        default=None,
    )
    summary = {
        "regime": regime,
        "epochs": cfg.epochs,
        "guard": args.guard,
        "preempted": preempted,
        "final_train_loss": engine.history[-1].train_loss if engine.history else None,
        "final_val_acc": engine.history[-1].val_acc if engine.history else None,
        "best_val_acc": best.val_acc if best else None,
        "wall_clock_s": round(wall, 3),
        "data_source": train_split.source,
        "device": str(engine.device),
        "kernels": cfg.kernels,
        "input_mode": cfg.input_mode,
        "compute_dtype": cfg.compute_dtype,
        "rank": rank if rank is not None else 0,
        "world": engine.mesh.world,
        # this process's head kernel launches (replays included): the
        # check that --kernels cuda ran the kernels on every path
        "head_launches": dict(fused_head.LAUNCHES),
    }
    log("SUMMARY " + json.dumps(summary))
    return engine


def main(argv=None, *, log=say) -> int:
    """`python -m distributed_neural_network_tpu_torch.train.cli`: the
    trainer with `--regime`. Defaults are small (synthetic data, 2,048 rows,
    one worker per visible device), as in the JAX package's module runner.

    The JAX package's three top-level scripts map onto --regime with their
    reference defaults:
      single_proc_train.py         --regime single --epochs 15 --batch-size 4
      model_replication_train.py   --regime replication --nb-proc 4 --epochs 10
      data_parallelism_train.py    --regime data_parallel --nb-proc 4 --epochs 25
    (with --data auto and no --synthetic-size for the full CIFAR-10 sizes).
    """
    parser = argparse.ArgumentParser(
        prog="python -m distributed_neural_network_tpu_torch.train.cli",
        description=main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    add_common_flags(parser, epochs=2, batch_size=16)
    add_distributed_flags(parser, nb_proc=None)
    parser.add_argument(
        "--regime", choices=("single", "data_parallel", "replication"),
        default="data_parallel",
    )
    parser.set_defaults(data="synthetic", synthetic_size=2048)
    args = parser.parse_args(argv)
    try:
        abort = None
        try:
            run_training(args, args.regime, log=log)
        except GuardAbort as e:
            # every rank observed the same loss and raises at the same epoch;
            # the exception's frames (and with them the engine's graphs) are
            # let go before the group is torn down below
            abort = str(e)
        if abort is not None:
            raise GuardAbort(abort)
    finally:
        if joined():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
