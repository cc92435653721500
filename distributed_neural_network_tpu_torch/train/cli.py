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
import sys
import time

import torch.distributed as dist

from ..data.cifar10 import load_split
from ..device import resolve_device
from ..ops import fused_head
from ..parallel.distributed import initialize, joined, rank_device
from ..utils import timers as T
from ..utils.logfiles import write_phase_logs
from ..utils.metrics import init_run
from .engine import SLICE4, Engine, TrainConfig

SLICE5 = "slice 5, static analysis (ROADMAP.md Queue 1 item 6)"

# dest -> (flag, the slice that brings it); each is parsed with default None
LATER_FLAGS = {
    "checkpoint_dir": ("--checkpoint-dir", SLICE4),
    "checkpoint_every": ("--checkpoint-every", SLICE4),
    "checkpoint_keep": ("--checkpoint-keep", SLICE4),
    "checkpoint_backend": ("--checkpoint-backend", SLICE4),
    "resume": ("--resume", SLICE4),
    "elastic": ("--elastic", SLICE4),
    "guard": ("--guard", SLICE4),
    "trace_out": ("--trace-out", SLICE4),
    "step_stats": ("--step-stats", SLICE4),
    "metrics_port": ("--metrics-port", SLICE4),
    "profile_dir": ("--profile-dir", SLICE4),
    "run_record": ("--run-record", SLICE4),
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
    train, write phase logs and print the SUMMARY line."""
    check_ported(args)
    cfg = config_from_args(args, regime)
    device = resolve_device(args.device)
    rank = None
    # before anything touches the card: it picks the rank's card and backend
    if initialize(device=device, log=log):
        device, rank = rank_device(device), dist.get_rank()
        log(f"(Multi-process: rank {rank}/{dist.get_world_size()}, backend "
            f"{dist.get_backend()}, device {device})")
    timers = T.PhaseTimers(device)
    syn = args.synthetic_size
    with timers.phase(T.DATA_LOADING):
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
    engine = Engine(cfg, train_split, test_split, device=device)
    engine.run(timers=timers, run=run, log=log, eval_every=args.eval_every,
               fused=args.fused)
    wall = time.perf_counter() - t0
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
        "guard": "off",
        "preempted": False,
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
        run_training(args, args.regime, log=log)
    finally:
        if joined():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
