"""The CNN trainer's command line (counterpart of the JAX package's
`train/cli.py`): the same flags, per-epoch lines, phase report, phase log
files and final ``SUMMARY {json}`` line.

    python -m distributed_neural_network_tpu_torch.train.cli --regime data_parallel \\
        --nb-proc 4 --epochs 2 --kernels cuda

Runs on the GPU unless ``--device cpu`` is given. ``--kernels torch`` (the
default, as ``xla`` is the JAX default) runs the classifier head as plain
PyTorch ops; ``--kernels cuda`` runs it as the hand-written fused CUDA kernel
(the JAX package's ``pallas``). Flags whose feature this port has not reached
yet are accepted and raise `NotImplementedError` naming the slice that brings
them.
"""

from __future__ import annotations

import argparse
import json
import time

from ..data.cifar10 import load_split
from ..device import resolve_device
from ..utils import timers as T
from ..utils.logfiles import write_phase_logs
from ..utils.metrics import init_run
from .engine import SLICE1_LATER, SLICE4, Engine, TrainConfig

SLICE5 = "slice 5, static analysis (ROADMAP.md Queue 1 items 15-16)"

# dest -> (flag, the slice that brings it); each is parsed with default None
LATER_FLAGS = {
    "fused": ("--fused", SLICE1_LATER + ": multi-epoch spans / CUDA graphs"),
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
    p.add_argument("--grad-sync", choices=("end", "overlap"), default="end")
    p.add_argument(
        "--precision", choices=("bf16", "fp8", "int8", "int8-kv"), default="bf16",
        help="only bf16 (the full-precision contract) runs the CNN trainer",
    )
    p.add_argument("--input-mode", choices=("hbm", "stream"), default="hbm")
    p.add_argument("--data", choices=("auto", "pickle", "npz", "synthetic"), default="auto")
    p.add_argument("--data-root", default=None, help="dataset dir (default ./data)")
    p.add_argument(
        "--synthetic-size", type=int, default=None,
        help="synthetic train rows (test = 1/5 of it); default: CIFAR-10 sizes",
    )
    p.add_argument("--log-dir", default="log", help="phase-time log directory")
    p.add_argument("--metrics-jsonl", default=None, help="metrics JSONL path")
    p.add_argument("--eval-batch-size", type=int, default=None)
    p.add_argument("--compute-dtype", choices=("float32", "bfloat16"), default="float32")
    p.add_argument(
        "--kernels", choices=("torch", "cuda"), default="torch",
        help="cuda = the hand-written fused classifier-head kernel "
        "(JAX: pallas); torch = plain PyTorch ops (JAX: xla)",
    )
    p.add_argument("--eval-every", type=int, default=1)
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
        grad_sync=args.grad_sync,
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


def run_training(args, regime: str, *, log=print) -> Engine:
    """Load data, train, write phase logs and print the SUMMARY line."""
    check_ported(args)
    cfg = config_from_args(args, regime)
    device = resolve_device(args.device)
    timers = T.PhaseTimers(device)
    syn = args.synthetic_size
    with timers.phase(T.DATA_LOADING):
        train_split = load_split(
            True, root=args.data_root, source=args.data, seed=args.seed,
            synthetic_size=syn,
        )
        test_split = load_split(
            False, root=args.data_root, source=args.data, seed=args.seed,
            synthetic_size=max(1, syn // 5) if syn else None,
        )
    log(
        f"(Loaded train dataset of length {len(train_split)} "
        f"[source={train_split.source}], test length {len(test_split)})"
    )

    run = init_run(jsonl_path=args.metrics_jsonl)
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
    }

    t0 = time.perf_counter()
    engine = Engine(cfg, train_split, test_split, device=device)
    engine.run(timers=timers, run=run, log=log, eval_every=args.eval_every)
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
    }
    log("SUMMARY " + json.dumps(summary))
    return engine


def main(argv=None, *, log=print) -> int:
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
    run_training(args, args.regime, log=log)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
