"""Train the transformer LM: the port of the JAX package's `lm_train.py`,
with its flags, its per-step ``step N  loss X`` lines, its MFU line and its
final ``SUMMARY {json}`` line (the same keys).

    python -m distributed_neural_network_tpu_torch.lm_train --attn flash \\
        --dtype bfloat16 --steps 20 --batch-size 16 --seq-len 2048 \\
        --vocab 32768 --d-model 512 --n-layers 8 --n-heads 8 --d-ff 2048 --lr 0.01

The mesh: ``--dp D --sp S --tp T`` is D*S*T ranks under torchrun, laid
out as the JAX CLI's ``create_lm_mesh(D, S, T)`` (model axis fastest), and
``--pp P --dp D --tp T`` D*P*T ranks on its pipeline mesh
``create_pp_mesh(D, P, T)`` (`parallel/pipeline.py`: the GPipe schedule of
``--microbatches M``, the interleaved one with ``--pp-interleave v``), each
joining the group through `parallel/distributed.py` `initialize` (NCCL when
every rank has a card of its own, gloo when ranks share one, gloo on the
CPU):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m distributed_neural_network_tpu_torch.lm_train --dp 2 --tp 2 [--attn flash] ...
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m distributed_neural_network_tpu_torch.lm_train --sp 2 --attn zigzag ...
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m distributed_neural_network_tpu_torch.lm_train --pp 4 --microbatches 4 ...

Every rank builds the same global batch (under ``--attn zigzag`` with
``--sp`` > 1 its sequence permuted into the zigzag layout) and feeds the
step its block: B/dp rows and S/sp columns (every stage of a pipeline the
same rows). ``--tp`` shards the heads and
the MLP's hidden columns (``--n-heads`` must divide by it); ``--sp`` runs
ring, Ulysses or zigzag attention (not flash, not a quantized
``--precision``). The loss lines and the SUMMARY are the group's, the same
on every rank (timings are the slowest rank's), each line written whole.
MFU is taken over the peak times the number of cards the ranks run on
(ranks that share a card count it once). ``--sharding manual`` (the rule
table) or ``rules:<file>`` (a JSON rule list, `parallel/rules.py`) gives
the parameters' specs (under ``--pp`` only ``manual``). The pipeline's
blocks attend with the plain local attention whatever ``--attn`` is, as the
JAX pipeline's; its SUMMARY carries ``pp_bubble_frac``, (P-1)/(v*M+P-1). The log line names the collectives' form, and the
line after the first step the step program's segments (one graph under
NCCL).

Runs on the GPU unless ``--device cpu`` is given; there the train step (and
the eval loss) is captured as CUDA graphs at the first step and replayed
after (one graph, unless gloo collectives split the step). ``--generate``
decodes eagerly (from the gathered parameters under ``--tp`` or expert
parallelism; skipped under ``--pp``, as the JAX CLI does). ``--experts N``
makes every block's MLP a mixture of N experts (`parallel/moe.py`: top-2,
capacity factor 2, sort dispatch, z-loss weight 0.1, the JAX defaults);
with ``--dp`` > 1 the experts are sharded over the data axis (N must divide
by it), on the pipeline's stages too. ``--remat --remat-policy NAME`` picks what a
recomputed block keeps (a `jax.checkpoint_policies` name,
`models/transformer.py` `REMAT_SAVES`). ``--attn
flash`` runs the hand-written flash kernels (`ops/flash_attention.py`; their
plain versions on the CPU; on H/tp heads under ``--tp``); ``--attn
ring|ulysses|zigzag`` at ``--sp 1`` is the plain local attention, as the
JAX `_attend` with no sequence axis. ``--precision
fp8|int8`` quantizes the attention forward. The task is the synthetic copy
task (a `torch.Generator` stream, not `jax.random`'s) unless ``--data-path``
names a token corpus. Flags of later slices raise `NotImplementedError`
naming the slice; ``--compilation-cache-dir`` is JAX-only and not a flag here.

Checkpoints, as the JAX CLI's: ``--checkpoint-dir D`` saves every
``--checkpoint-every`` steps and at the end (`utils/checkpoint.py`
`TreeCheckpointer`, the JAX npz layout of ``{"params", "mom"}``: every rank
gathers the whole tree, rank 0 writes); ``--resume`` restores the newest
checkpoint into the step's own tensors and continues bit for bit (the same
flags, the same mesh; a non-empty directory without ``--resume`` is
refused); ``--stop-at-step N`` ends the run before step N; ``--on-sigterm
checkpoint`` (the default) turns SIGTERM / SIGINT into an emergency
checkpoint at the next step boundary that every rank agrees on, and a clean
exit. Under the elastic supervisor (``python -m
distributed_neural_network_tpu_torch.launch``, `train/supervisor.py`, which
sets ``DNN_TPU_SUPERVISOR``) the exit code tells the supervisor what
happened, as the JAX CLI's does: a rank preempted by its own signal or
watchdog exits ``PREEMPT_RC`` (75) once its emergency checkpoint, run
record and flight dump are written; a rank that stopped only because a peer
asked (the agreed flag's ``PEER``) exits 0, and so does a rank whose
collective failed because a peer process died (`parallel/distributed.py`
`peer_lost`: one ``(peer lost ...)`` line, a ``peer_lost`` flight event, the
run record finalized): both are collateral, so the group shrinks by the one
rank that failed. Both skip the group's teardown (``os._exit``).

Telemetry: ``--trace-out`` (one fenced ``train_step`` span a step,
per-rank shards under torchrun), ``--step-stats``, ``--run-record`` (the
goodput record; the GOODPUT line is printed either way) and
``--metrics-jsonl`` (the ``train/loss`` series, and ``step/*`` with
``--step-stats``).

The monitor, as the JAX CLI's (`train/monitor.py`): ``--metrics-port P``
serves ``/metrics`` (Prometheus text), ``/healthz`` and, with
``--profile-dir`` (or next to ``--trace-out``), ``/profile?steps=N`` (a
`torch.profiler` Chrome trace of the next N steps); ``--watchdog on`` (the
default) flags stalls, recompile storms and stale checkpoints,
``--watchdog-escalate preempt`` turns a persistent stall into the emergency
checkpoint; ``--metrics-linger S`` keeps the server up after the run. The
supervisor's ``DNN_TPU_HEARTBEAT_FILE`` and ``DNN_TPU_FLIGHT_FILE`` arm the
heartbeat file and the flight recorder's dump.

The training guard, as the JAX CLI's (`train/guard.py`): ``--guard
warn|skip|rollback|abort`` reads each step's health (loss, global gradient
norm, all-finite flag) one step late, after the next step's launch;
``skip`` drops a non-finite update inside the step (on the device: the
step stays one CUDA graph); ``rollback`` restores the rolling host snapshot
(every ``--snapshot-every`` steps, or the newest checkpoint) and retries at
a backed-off lr (the captured step is kept: it reads its lr from a buffer),
at most ``--max-retries`` times; ``abort`` raises `GuardAbort`. Fault
injection (`parallel/fault.py`): ``--chaos-nan-step N`` (NaN gradients in
the step, ``--chaos-nan-layer`` to restrict them), ``--chaos-spike-step``
(the observed loss x100, once), ``--chaos-sigterm-after`` (a real SIGTERM)
and ``--chaos-stall-step`` / ``--chaos-stall-seconds`` /
``--chaos-stall-rank`` (a host sleep). Mesh path only (not ``--pp``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from .device import resolve_device
from .models import transformer as tfm
from .ops.schedule import make_ema_update, warmup_cosine
from .parallel.distributed import distribute_host_data, initialize, joined, peer_lost
from .parallel import pipeline as ppl
from .parallel.collectives import COLLECTIVE_FORMS
from .parallel.ring import zigzag_order
from .train import lm as lmtrain
from .train.cli import SLICE5, say
from .train.engine import SLICE4
from .train import guard as G
from .train.guard import PreemptionGuard, check_cursor, resume_cursor
from .train.measure import model_flops_per_token, peak_flops
from .train.supervisor import PREEMPT_RC
from .utils import tracing as TR
from .utils.goodput import LEDGER, RUN_RECORD_ENV

# set by the supervisor (`train/supervisor.py`) in every worker's environment
SUPERVISOR_ENV = "DNN_TPU_SUPERVISOR"
# the keys of the JAX CLI's SUMMARY line, in its order
SUMMARY_KEYS = (
    "mesh", "steps", "start_step", "last_step", "preempted", "guard", "guard_summary",
    "dtype", "pp_bubble_frac", "grad_sync", "accum_steps", "dynamics", "data_source", "eval",
    "first_loss", "final_loss", "tokens_per_s", "wall_s_post_compile", "model_tflops_per_s",
    "mfu_pct",
)

# the checkpoint's momentum-layout version (the JAX CLI's MOM_FORMAT)
MOM_FORMAT = "tree"
# the arguments that do not shape the computation: left out of the run
# record's config fingerprint (the JAX CLI's list, and --device)
VOLATILE_ARGS = {
    "run_record", "metrics_port", "metrics_linger", "trace_out", "profile_dir", "metrics_jsonl",
    "checkpoint_dir", "log_every", "device",
}

# dest -> (flag, the slice that brings it); each is parsed with default None
LATER_FLAGS = {
    "dynamics": ("--dynamics", SLICE4),
    "dynamics_jsonl": ("--dynamics-jsonl", SLICE4),
}
INT8_KV_MESSAGE = (
    "--precision int8-kv quantizes the SERVING KV cache (paged pool + per-block scales); it "
    "is a flag of python -m distributed_neural_network_tpu.serve. Training's quantized paths "
    "are --precision fp8|int8"
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m distributed_neural_network_tpu_torch.lm_train",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; asking for cuda without a GPU is an error")
    p.add_argument("--dp", type=int, default=1, help="data-parallel axis size")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel axis size (ring/ulysses/zigzag attention)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel axis size; run dp*sp*tp processes under torchrun")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (the dp x pp x tp mesh; exclusive with --sp; zero "
                   "optimizers compose with --dp, not --tp)")
    p.add_argument("--sharding", default="manual", metavar="MODE",
                   help="'manual' (default): the parameters' specs from the partition-rule "
                   "table (parallel/rules.py); 'rules:<file>': a custom ordered [regex, spec] "
                   f"JSON rule list (every leaf must match); 'auto' comes with {SLICE5}")
    p.add_argument("--microbatches", type=int, default=2)
    p.add_argument("--pp-interleave", type=int, default=1,
                   help="virtual pipeline stages per device (circular schedule): cuts the "
                   "bubble from (P-1)/(M+P-1) to (P-1)/(v*M+P-1) at the cost of v-times-finer "
                   "layer chunks; needs pp*v | layers and pp | microbatches")
    p.add_argument("--attn", choices=("ring", "ulysses", "zigzag", "flash"), default="ring",
                   help="ring/ulysses/zigzag at --sp 1 = plain local attention; flash = the "
                   "hand-written flash kernels")
    p.add_argument("--experts", type=int, default=0, help="MoE experts (0 = dense)")
    p.add_argument("--optimizer", choices=lmtrain.OPTIMIZERS, default="sgd")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32, help="global batch")
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--d-ff", type=int, default=512)
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--precision", choices=("bf16", "fp8", "int8", "int8-kv"), default="bf16",
                   help="fp8/int8 quantize the attention forward (backward full precision)")
    p.add_argument("--loss-chunks", type=int, default=0,
                   help="CE in this many sequence chunks (0 = auto by a 64 MB logits "
                   "budget, 1 = single pass)")
    p.add_argument("--remat", action="store_true", help="recompute every block in backward")
    p.add_argument("--remat-policy", default="",
                   help="with --remat: a jax.checkpoint_policies name (dots_saveable, "
                   "dots_with_no_batch_dims_saveable, nothing_saveable, everything_saveable "
                   "and their checkpoint_dots* aliases); '' recomputes the whole block")
    p.add_argument("--remat-attn", action="store_true",
                   help="recompute only the attention call in backward")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--lr-schedule", choices=("constant", "cosine"), default="constant")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--min-lr-frac", type=float, default=0.0)
    p.add_argument("--clip-norm", type=float, default=0.0)
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--grad-sync", choices=("end", "overlap"), default="end",
                   help="end = one all-reduce after the accumulation; overlap = one "
                   "collective per micro-batch and leaf bucket (--bucket-mb)")
    p.add_argument("--bucket-mb", type=float, default=4.0,
                   help="gradient-bucket payload cap in MiB for --grad-sync overlap")
    p.add_argument("--ema-decay", type=float, default=0.0)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--momentum", type=float, default=0.9,
                   help="SGD momentum; Adam's b1 with --optimizer adam")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-path", default=None, help="token corpus (.npy, .bin, .txt)")
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--gen-temperature", type=float, default=0.0)
    p.add_argument("--gen-top-k", type=int, default=0)
    p.add_argument("--gen-top-p", type=float, default=0.0)
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training, decode N tokens from the first two prompts")
    p.add_argument("--stop-at-step", type=int, default=None, metavar="N",
                   help="stop before step N (absolute, resume-aware) instead of after "
                   "--steps more steps; the lr schedule still spans --steps")
    p.add_argument("--metrics-jsonl", default=None,
                   help="append the train/loss (+ val/loss on --eval-every) series to this "
                   "JSONL file (utils/metrics.py), and step/* with --step-stats")
    p.add_argument("--run-record", default=None, metavar="RECORD.json",
                   help="write the goodput run record here (utils/goodput.py: goodput ratio "
                   "+ per-cause badput seconds, config fingerprint, mesh, step/token "
                   "counts; written through during the run; render/diff/gate with "
                   f"tools/goodput.py). Defaults to the {RUN_RECORD_ENV} environment "
                   "variable; the breakdown is printed as a GOODPUT line either way")
    p.add_argument("--trace-out", default=None, metavar="TRACE.json",
                   help="write a Chrome trace-event JSON of the run (one train_step span "
                   "per step, fenced: the card is waited for at each step); per-rank "
                   "shards under torchrun; summarize with tools/trace_summary.py")
    p.add_argument("--step-stats", action="store_true",
                   help="collect per-step StepStats (compile vs steady step time, "
                   "tokens/s, device memory, collective bytes, MFU from the analytic "
                   "FLOPs), print the summary, and emit step/* series to --metrics-jsonl")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve live Prometheus metrics on http://127.0.0.1:PORT/metrics plus a "
                   "/healthz JSON liveness/readiness endpoint (0 = ephemeral port, printed at "
                   "startup); also starts the stall/recompile/checkpoint watchdog unless "
                   "--watchdog off (utils/obs.py, train/monitor.py; watch live with "
                   "tools/live_top.py http://127.0.0.1:PORT)")
    p.add_argument("--metrics-linger", type=float, default=0.0, metavar="SEC",
                   help="keep the metrics server up this many seconds after the run finishes "
                   "(final scrape window)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="with --metrics-port: serve /profile?steps=N - an on-demand "
                   "torch.profiler capture of the next N steps, written under DIR (default: "
                   "next to --trace-out when set; without either the endpoint answers 501)")
    p.add_argument("--watchdog", choices=("on", "off"), default="on",
                   help="with --metrics-port: background watchdog flagging stalled steps (no "
                   "heartbeat for N x steady p95 step time), recompile storms, and checkpoint "
                   "staleness as watchdog/* trace events + watchdog_*_total counters")
    p.add_argument("--watchdog-escalate", choices=("none", "preempt"), default="none",
                   help="preempt = a persistent stall requests the cooperative preemption path "
                   "(emergency checkpoint at the next step boundary every rank agrees on, clean "
                   "exit); requires --on-sigterm checkpoint")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save params+momentum every --checkpoint-every steps")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint-dir")
    p.add_argument("--elastic", action="store_true",
                   help="elastic resume (parallel/reshard.py): accept a checkpoint saved under a "
                   "DIFFERENT mesh shape or optimizer layout and reshard it onto this run's mesh "
                   "- dp/sp/tp may all change, ZeRO shards re-pad for the new dp, and "
                   "sgd<->zero / adam<->zero-adam convert bitwise; the global batch stays fixed "
                   "(grad accumulation is re-sliced) so the exact-resume data cursor still holds")
    p.add_argument("--on-sigterm", choices=("checkpoint", "ignore"), default="checkpoint",
                   help="checkpoint = on SIGTERM/SIGINT finish the current step, write an "
                   "emergency checkpoint (when --checkpoint-dir is set) and exit cleanly; "
                   "resume replays from the exact batch, bit-identical. ignore = default "
                   "signal behavior")
    p.add_argument("--guard", choices=G.POLICIES, default="off",
                   help="self-healing step guard (train/guard.py): the step emits a health "
                   "bundle (loss, global grad-norm, all-finite flag) observed one step behind "
                   "the launches. warn = count/log anomalies; skip = additionally drop "
                   "non-finite updates inside the step on the device (params/momentum pass "
                   "through unchanged); rollback = restore the rolling in-memory snapshot (or "
                   "newest checkpoint) and retry with LR backoff; abort = stop with an "
                   "actionable error. Mesh path only (not --pp)")
    p.add_argument("--guard-spike-zscore", type=float, default=6.0,
                   help="loss-spike threshold in EMA standard deviations; non-finite steps "
                   "always count as anomalies")
    p.add_argument("--snapshot-every", type=int, default=50,
                   help="steps between the guard's rolling host snapshots (one host copy of "
                   "params+optimizer state each; a rollback rewinds at most this many steps)")
    p.add_argument("--max-retries", type=int, default=3,
                   help="guard rollback budget before abort (refills after a stretch of "
                   "healthy steps)")
    p.add_argument("--chaos-nan-step", type=int, action="append", default=None, metavar="N",
                   help="fault injection (parallel/fault.py): NaN the gradients at step N "
                   "inside the step (repeatable); exercises the guard's in-step skip path")
    p.add_argument("--chaos-nan-layer", default=None, metavar="REGEX",
                   help="restrict --chaos-nan-step to gradient leaves whose /-joined tree "
                   "path matches this regex (parallel/fault.py nan_layer; e.g. 'layers/w1')")
    p.add_argument("--chaos-spike-step", type=int, action="append", default=None, metavar="N",
                   help="fault injection: multiply the OBSERVED loss at step N by 100 "
                   "(host-side, fires once, so a rollback replay sees a healthy step)")
    p.add_argument("--chaos-sigterm-after", type=int, default=None, metavar="N",
                   help="fault injection: deliver a real SIGTERM to this process after step N "
                   "completes (drives the emergency-checkpoint -> exact-resume path end to "
                   "end; acted on at the next step's boundary)")
    p.add_argument("--chaos-stall-step", type=int, action="append", default=None, metavar="N",
                   help="fault injection: sleep --chaos-stall-seconds on the host after step "
                   "N completes (repeatable; host-side, works under --pp too)")
    p.add_argument("--chaos-stall-seconds", type=float, default=2.0, metavar="SEC",
                   help="stall duration for --chaos-stall-step")
    p.add_argument("--chaos-stall-rank", type=int, default=None, metavar="R",
                   help="restrict --chaos-stall-step to process rank R of a multi-process "
                   "group (every rank runs the same argv, so without this the whole group "
                   "stalls in lockstep); single-process runs treat their rank as 0")
    p.add_argument("--chaos-shrink-at-step", type=int, default=None, metavar="N",
                   help="fault injection (parallel/fault.py): after step N raise a cooperative "
                   "SHRINK preemption - the elastic path writes an emergency checkpoint, "
                   "re-forms the process group over the first --chaos-shrink-to x sp x tp ranks "
                   "(the others leave with exit 0), reshards params+optimizer state onto their "
                   "mesh (parallel/reshard.py) and CONTINUES training: the full preempt -> "
                   "checkpoint -> reshard -> resume path. Requires --checkpoint-dir and "
                   "--on-sigterm checkpoint; mesh path only (not --pp)")
    p.add_argument("--chaos-shrink-to", type=int, default=None, metavar="DP",
                   help="data-parallel size the SHRINK preemption drops to (default dp//2); "
                   "sp/tp are kept, the global batch is preserved by re-slicing gradient "
                   "accumulation")
    for dest, (flag, later) in LATER_FLAGS.items():
        p.add_argument(flag, dest=dest, nargs="?", const=True, default=None,
                       help=f"not ported yet: {later}")
    return p


def validate(p: argparse.ArgumentParser, args) -> None:
    """The JAX CLI's argument checks that apply on one device."""
    if args.steps < 1:
        p.error("--steps must be >= 1")
    if args.checkpoint_every < 1:
        p.error("--checkpoint-every must be >= 1")
    if args.resume and not args.checkpoint_dir:
        p.error("--resume requires --checkpoint-dir")
    if args.stop_at_step is not None and args.stop_at_step < 1:
        p.error(f"--stop-at-step must be >= 1, got {args.stop_at_step}")
    if args.remat_policy and not args.remat:
        p.error("--remat-policy only applies with --remat (the policy picks WHAT checkpointed "
                "blocks save); the name is validated against jax.checkpoint_policies after "
                "startup")
    if args.eval_every and not args.data_path:
        p.error("--eval-every requires --data-path (the held-out split is the token "
                "stream's tail)")
    if args.gen_temperature < 0:
        p.error(f"--gen-temperature must be >= 0, got {args.gen_temperature}")
    if not 0.0 <= args.gen_top_p <= 1.0:
        p.error(f"--gen-top-p must be in [0, 1], got {args.gen_top_p}")
    if (args.gen_top_k or args.gen_top_p) and args.gen_temperature <= 0:
        p.error("--gen-top-k/--gen-top-p only apply when sampling; set --gen-temperature > 0")
    if args.generate <= 0 and (args.gen_temperature > 0 or args.gen_top_k or args.gen_top_p):
        p.error("--gen-temperature/--gen-top-k/--gen-top-p configure --generate N, which was "
                "not requested")
    if args.loss_chunks > 1 and (args.seq_len // max(args.sp, 1)) % args.loss_chunks:
        p.error(f"--loss-chunks {args.loss_chunks} must divide the per-shard sequence length "
                f"{args.seq_len // max(args.sp, 1)} (--seq-len / --sp; the CE is chunked "
                "along the local sequence axis)")
    if args.attn == "zigzag" and args.sp > 1 and args.seq_len % (2 * args.sp):
        p.error(f"--attn zigzag needs --seq-len divisible by 2*sp ({2 * args.sp}); got "
                f"{args.seq_len}")
    if args.attn == "flash" and args.sp > 1:
        p.error("--attn flash is the local (per-device) kernel and composes with --dp/--tp "
                "(own vma-typed Pallas kernels, round 4); a sequence axis needs --attn "
                "ring/ulysses/zigzag")
    if args.precision == "int8-kv":
        p.error(INT8_KV_MESSAGE)
    if args.precision != "bf16" and args.sp > 1:
        p.error(f"--precision {args.precision} quantizes the LOCAL attention matmuls; a "
                "sequence axis (ring/ulysses/zigzag) has no quantized path - drop --sp or "
                "--precision")
    if args.n_heads < 1 or args.d_model % args.n_heads:
        p.error(f"--d-model {args.d_model} must divide by --n-heads {args.n_heads}")
    if args.sharding not in ("manual", "auto") and not args.sharding.startswith("rules:"):
        p.error(f"--sharding must be 'manual', 'auto', or 'rules:<file>', got {args.sharding!r}")
    if args.sharding == "rules:":
        p.error("--sharding rules: needs a file path (rules:<file>)")
    if args.grad_sync == "overlap" and args.experts and args.dp > 1:
        p.error("--grad-sync overlap psums gradient buckets over the data axis; expert-sharded "
                "leaves (--experts with --dp > 1) vary over that axis - use --grad-sync end")
    if args.sharding != "manual" and args.pp > 1:
        p.error("--sharding auto/rules:<file> drive the dp x sp x tp mesh path's partition "
                "layer (parallel/rules.py); the pipeline path's stage sharding is fixed by "
                "--pp - drop --pp or use --sharding manual")
    if args.ema_decay and args.pp > 1:
        p.error("--ema-decay is unused under --pp (the pipeline path has no "
                "--eval-every/--generate consumer for the averaged weights); drop it or use "
                "the dp x sp x tp mesh")
    if args.precision != "bf16" and args.pp > 1:
        p.error(f"--precision {args.precision} is wired through the dp x sp x tp mesh step; "
                "the pipeline path does not thread attn_quant - drop --pp or --precision")
    if args.bucket_mb <= 0:
        p.error(f"--bucket-mb must be > 0, got {args.bucket_mb}")
    for flag in ("dp", "sp", "tp", "pp", "microbatches", "pp_interleave"):
        if getattr(args, flag) < 1:
            p.error(f"--{flag.replace('_', '-')} must be >= 1, got {getattr(args, flag)}")
    if args.batch_size % (args.dp * args.accum_steps):
        p.error(f"--batch-size {args.batch_size} must divide by --dp x --accum-steps "
                f"({args.dp} x {args.accum_steps}): each rank's rows split into the "
                "micro-batches")
    # --chaos-stall-step is not in this set: a host-side sleep, it works under --pp
    chaos_injected = bool(args.chaos_nan_step or args.chaos_spike_step
                          or args.chaos_sigterm_after is not None)
    if args.pp > 1 and (args.guard != "off" or chaos_injected):
        p.error("--guard / --chaos-* are wired through the dp x sp x tp mesh step's health "
                "bundle (train/lm.py make_lm_train_step); the pipeline path has no health "
                "output yet - drop --pp or the guard flags")
    if args.chaos_stall_seconds <= 0:
        p.error(f"--chaos-stall-seconds must be > 0, got {args.chaos_stall_seconds}")
    if args.chaos_stall_rank is not None and not args.chaos_stall_step:
        p.error("--chaos-stall-rank restricts --chaos-stall-step, which was not given")
    if args.chaos_nan_layer is not None and not args.chaos_nan_step:
        p.error("--chaos-nan-layer restricts --chaos-nan-step, which was not given")
    if args.elastic and not args.resume and args.chaos_shrink_at_step is None:
        p.error("--elastic configures how --resume (or a SHRINK preemption) maps a checkpoint "
                "onto this mesh; add --resume with --checkpoint-dir, or --chaos-shrink-at-step")
    if args.chaos_shrink_at_step is not None:
        if args.pp > 1:
            p.error("--chaos-shrink-at-step shrinks the dp x sp x tp mesh in process; drop --pp")
        if not args.checkpoint_dir:
            p.error("--chaos-shrink-at-step drives the preempt -> checkpoint -> reshard -> "
                    "resume path; it requires --checkpoint-dir")
        if args.on_sigterm != "checkpoint":
            p.error("--chaos-shrink-at-step rides the cooperative preemption guard; it requires "
                    "--on-sigterm checkpoint")
        if args.eval_every:
            p.error("--chaos-shrink-at-step cannot rebuild the --eval-every evaluator mid-run; "
                    "drop one of the two")
        if args.chaos_shrink_to is None:
            args.chaos_shrink_to = max(args.dp // 2, 1)
        if not 1 <= args.chaos_shrink_to < args.dp:
            p.error(f"--chaos-shrink-to must be in [1, dp) = [1, {args.dp}), got "
                    f"{args.chaos_shrink_to}")
        if args.batch_size % args.chaos_shrink_to:
            p.error(f"--batch-size {args.batch_size} must divide over --chaos-shrink-to "
                    f"{args.chaos_shrink_to} (the global batch is preserved across the shrink)")
    if args.watchdog_escalate == "preempt" and args.on_sigterm != "checkpoint":
        p.error("--watchdog-escalate preempt rides the cooperative preemption path; it "
                "requires --on-sigterm checkpoint")
    if args.snapshot_every < 1:
        p.error(f"--snapshot-every must be >= 1, got {args.snapshot_every}")
    if args.max_retries < 0:
        p.error(f"--max-retries must be >= 0, got {args.max_retries}")
    if args.pp > 1 and args.batch_size % (args.dp * args.accum_steps * args.microbatches):
        p.error(f"--batch-size {args.batch_size} must divide by --dp x --accum-steps x "
                f"--microbatches ({args.dp} x {args.accum_steps} x {args.microbatches}) under "
                "--pp: each schedule pass splits its rows into the microbatches")


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag whose feature is not ported yet."""
    for dest, (flag, later) in LATER_FLAGS.items():
        if getattr(args, dest) is not None:
            raise NotImplementedError(f"{flag} is not ported yet; it comes with {later}")
    if args.sharding == "auto":
        raise NotImplementedError(f"--sharding auto is not ported yet; it comes with {SLICE5}")


def schedule_at(args, lr_scale: float):
    """The lr schedule at ``--lr`` x `lr_scale` (the guard's backoff scales
    the schedule's base lr, as the JAX CLI's rebuilt step does), or None for
    a constant lr."""
    if args.lr_schedule != "cosine":
        return None
    return functools.partial(warmup_cosine, base_lr=args.lr * lr_scale, total_steps=args.steps,
                             warmup_steps=args.warmup_steps, min_lr_frac=args.min_lr_frac)


def fault_plan(args):
    """The in-step fault plan of ``--chaos-nan-step`` (None without one)."""
    if not args.chaos_nan_step:
        return None
    from .parallel.fault import StepFaultPlan

    return StepFaultPlan(nan_grads_at=tuple(args.chaos_nan_step), nan_layer=args.chaos_nan_layer)


def _cards(mesh) -> int:
    """The number of distinct devices the ranks run on (ranks that share a
    card count it once); 1 off a group."""
    if not mesh.joined:
        return 1
    where = [None] * mesh.world
    dist.all_gather_object(where, (socket.gethostname(), str(mesh.device)))
    return len(set(where))


def _group_max(x: float, mesh) -> float:
    """The largest of the ranks' `x` over the whole mesh (the group's time
    is its slowest rank's)."""
    if not mesh.joined:
        return x
    t = torch.tensor([x], dtype=torch.float64,
                     device=mesh.device if mesh.backend == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def main(argv=None, *, log=say, result: dict | None = None) -> int:
    """Run the CLI. Under torchrun it joins the process group (and leaves it
    at the end, unless the caller had joined it). `result`, when given, is
    filled with the run's per-step losses (the group's mean), its
    parameter and optimizer-state tensors, the step and the mesh, for
    callers that drive the entry point in-process. Under a supervisor
    (``DNN_TPU_SUPERVISOR`` set) a preempted or peer-lost rank ends the
    process itself, with the exit code the supervisor reads (module
    docs)."""
    p = build_parser()
    args = p.parse_args(argv)
    validate(p, args)
    check_ported(args)
    # the goodput wall clock starts before the rendezvous and the kernels'
    # build (the init bucket holds them); one ledger per run
    LEDGER.reset()
    LEDGER.start()
    record = args.run_record or os.environ.get(RUN_RECORD_ENV)
    if record:
        LEDGER.arm(record)
    if args.remat_policy and args.remat_policy not in tfm.REMAT_POLICIES:
        raise SystemExit(f"--remat-policy {args.remat_policy!r} is not a "
                         "jax.checkpoint_policies name")
    if args.n_heads % max(args.tp, 1):
        raise SystemExit(f"--n-heads {args.n_heads} must divide by --tp {args.tp}")
    if args.pp > 1:
        if args.sp > 1:
            raise SystemExit(
                "--pp composes with --dp/--tp/--experts and any --optimizer (zero/zero-adam "
                "shard state over dp per stage; not with --experts or --tp); --sp runs on the "
                "dp x sp x tp mesh (drop --pp)")
        if args.optimizer.startswith("zero") and (args.tp > 1 or (args.experts and args.dp > 1)):
            raise SystemExit(
                "--pp with zero optimizers composes with --dp only (tensor- and "
                "expert-sharded leaves are out of the per-leaf ZeRO layout's scope, same rule "
                "as the mesh path; --experts with --dp 1 keeps experts replicated and is fine)")
    device = resolve_device(args.device)
    owned = not joined()
    try:
        # before anything touches the card: it picks the rank's card and backend
        initialize(device=device, log=log)
        if args.pp > 1:
            mesh = ppl.create_pp_mesh(args.dp, args.pp, args.tp, device=device)
        else:
            mesh = lmtrain.create_lm_mesh(args.dp, args.sp, args.tp, device=device)
        if mesh.joined and owned:
            log(f"(Multi-process: rank {mesh.rank}/{mesh.world}, backend {mesh.backend}, device "
                f"{mesh.device})")
        abort = None
        try:
            ending = _train(args, mesh, log, result)
        except G.GuardAbort as e:
            # every rank judged the same health and raises at the same step;
            # the exception's frames (and with them the step's graphs) are
            # let go before the group is torn down below
            abort = str(e)
        if abort is not None:
            raise G.GuardAbort(abort)
        if ending is not None and os.environ.get(SUPERVISOR_ENV):
            # the supervisor reads the exit code: PREEMPT_RC for this rank's
            # own preemption (checkpoint on disk, restart the group from it),
            # 0 for a rank that stopped for a peer or lost one (collateral:
            # its peer's exit names the failure). os._exit skips the group's
            # teardown, which a preempted or lost peer would hold (and an
            # NCCL group must not be destroyed under its step's live graphs)
            import sys

            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(PREEMPT_RC if ending == "preempted" else 0)
    finally:
        if owned and joined():
            # the step's graphs (and their NCCL collectives) go first
            gc.collect()
            dist.destroy_process_group()
    return 0


@dataclasses.dataclass(frozen=True)
class Rebuild:
    """What an in-process shrink makes again on the survivors' mesh: the
    run's state tensors (`state(mesh)` -> params, specs, optimizer state),
    its step (`step(mesh, lr_scale)`), this rank's share of a host batch
    (`rows(mesh)`) and the first host batch (tokens, targets)."""

    state: object
    step: object
    rows: object
    host_batch: tuple


def _zero_params(cfg) -> dict:
    """The whole parameter tree as zeros (`init_params`' shapes, no draw):
    the tensors a restore then overwrites."""
    def zeros(node):
        if isinstance(node, dict):
            return {k: zeros(v) for k, v in node.items()}
        return torch.zeros(node)

    return zeros(tfm.param_shapes(cfg))


def _placed_state(args, cfg, mesh, whole, rules):
    """(this rank's parameters, their specs, its fresh optimizer state) on
    `mesh` from the whole tree `whole`."""
    if args.pp > 1:
        params, specs = ppl.shard_pp_params(whole, cfg, mesh, interleave=args.pp_interleave)
    else:
        params, specs = lmtrain.shard_params(whole, cfg, mesh, rules=rules)
    if args.pp > 1 and args.optimizer.startswith("zero"):
        mom = ppl.init_pp_zero_state(params, mesh, args.optimizer)
    else:
        mom = lmtrain.init_lm_momentum(params, args.optimizer, mesh)
    return params, specs, mom


def _build_step(args, cfg, mesh, rules, lr_scale: float = 1.0):
    """The train step on `mesh` at ``--lr`` x `lr_scale` (the guard's
    backoff) with the run's accumulation steps."""
    lr_schedule = schedule_at(args, lr_scale)
    if args.pp > 1:
        return ppl.make_pp_train_step(
            cfg, mesh, device=mesh.device, n_microbatches=args.microbatches,
            lr=args.lr * lr_scale, momentum=args.momentum, loss_chunks=args.loss_chunks,
            interleave=args.pp_interleave, lr_schedule=lr_schedule, clip_norm=args.clip_norm,
            weight_decay=args.weight_decay, optimizer=args.optimizer,
            accum_steps=args.accum_steps, grad_sync=args.grad_sync, bucket_mb=args.bucket_mb)
    return lmtrain.make_lm_train_step(
        cfg, mesh=mesh, device=mesh.device, lr=args.lr * lr_scale, momentum=args.momentum,
        attn_impl=args.attn, optimizer=args.optimizer, loss_chunks=args.loss_chunks,
        lr_schedule=lr_schedule, clip_norm=args.clip_norm, accum_steps=args.accum_steps,
        weight_decay=args.weight_decay, grad_sync=args.grad_sync, bucket_mb=args.bucket_mb,
        rules=rules, with_health=args.guard != "off", skip_nonfinite=args.guard == "skip",
        fault_plan=fault_plan(args),
    )


def _train(args, mesh, log, result) -> str | None:
    """Build the run on `mesh` and train; how it ended, for a supervisor:
    None (done), "preempted" (this rank's own request), "peer" (stopped
    for a peer's request) or "peer_lost" (a supervised rank whose
    collective failed because a peer process died)."""
    device = mesh.device
    cfg = tfm.TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        remat=args.remat, remat_policy=args.remat_policy, remat_attn=args.remat_attn,
        n_experts=args.experts, attn_quant="" if args.precision == "bf16" else args.precision,
    )
    rules = None
    if args.sharding.startswith("rules:"):
        from .parallel.rules import load_rules

        rules_path = args.sharding[len("rules:"):]
        rules = load_rules(rules_path)
        log(f"(sharding rules: {rules_path}, {len(rules)} rule(s))")
    pipe = args.pp > 1
    whole = tfm.init_params(args.seed, cfg)
    n_params = tfm.param_count(whole)
    params, specs, mom = _placed_state(args, cfg, mesh, whole, rules)
    del whole
    cards = _cards(mesh)

    zperm = None
    if args.attn == "zigzag" and args.sp > 1:
        # the zigzag layout: each sequence rank's shard holds one early and
        # one late chunk; the loss is a mean over positions, so one
        # permutation of tokens and targets leaves it unchanged
        zperm = torch.from_numpy(zigzag_order(args.seq_len, args.sp)).long()

    def rows_on(mesh):
        def rows(tok, tgt, whole_batch=False):
            """This rank's block of the global batch (the batch itself at 1
            x 1 x 1): its rows and sequence columns, or (`whole_batch`, an
            eval batch off the pipeline and off expert parallelism) every
            row and its columns. The pipeline's eval, and the eval under
            expert parallelism, take their data shard's rows, as their
            step."""
            if zperm is not None:
                tok, tgt = tok[:, zperm], tgt[:, zperm]
            return tuple(distribute_host_data(x, mesh, device=mesh.device, rows=not whole_batch)
                         for x in (tok, tgt))

        return rows

    stream = batch_at = None
    if args.data_path:
        from .data.tokens import load_token_stream, sample_batch

        stream = load_token_stream(args.data_path, vocab_size=args.vocab)
        log(f"(token stream: {len(stream.tokens):,} tokens [{stream.source}], "
            f"{stream.n_eval:,} held out)")

        def batch_at(i, split="train"):
            tok, tgt = sample_batch(stream, batch=args.batch_size, seq_len=args.seq_len,
                                    step=i, seed=args.seed, split=split)
            return torch.from_numpy(tok).long(), torch.from_numpy(tgt).long()

        host_batch = batch_at(0)
    else:
        host_batch = lmtrain.make_copy_task(
            torch.Generator().manual_seed(args.seed + 1), batch=args.batch_size,
            seq_len=args.seq_len, vocab=args.vocab)
    # what an in-process shrink rebuilds on the survivors' mesh
    rebuild = Rebuild(
        state=lambda mesh: _placed_state(args, cfg, mesh, _zero_params(cfg), rules),
        step=lambda mesh, lr_scale: _build_step(args, cfg, mesh, rules, lr_scale),
        rows=rows_on, host_batch=host_batch)
    eval_fn = None
    if args.eval_every and pipe:
        eval_fn = ppl.make_pp_eval_fn(cfg, mesh, n_microbatches=args.microbatches,
                                      loss_chunks=args.loss_chunks,
                                      interleave=args.pp_interleave)
    elif args.eval_every:
        eval_fn = lmtrain.make_eval_fn(cfg, attn_impl=args.attn, loss_chunks=args.loss_chunks,
                                       mesh=mesh)
    whole_eval = not pipe and not (eval_fn is not None and eval_fn.sharded_rows)
    sync = ""
    if mesh.joined:
        sync = f", collectives {COLLECTIVE_FORMS[mesh.form]}"
    log(f"(LM {n_params:,} params, mesh {mesh.desc}, "
        f"attn={args.attn if args.sp > 1 or args.attn == 'flash' else 'full'}, "
        + (f"precision={args.precision}, " if args.precision != "bf16" else "")
        + f"experts={args.experts or 'dense'}, optimizer={args.optimizer}, "
        f"grad_sync={args.grad_sync}, "
        f"device={device}{sync})")

    rank = mesh.rank if mesh.joined else None
    LEDGER.rank = rank
    LEDGER.describe(
        config={k: v for k, v in sorted(vars(args).items()) if k not in VOLATILE_ARGS},
        mesh={"axes": dict(mesh.shape), "devices": mesh.world, "desc": mesh.desc,
              "optimizer": args.optimizer},
    )
    tracer = TR.Tracer(enabled=bool(args.trace_out))
    trace_out = args.trace_out
    if rank is not None:
        # rank-stamped process lanes and one trace shard per rank
        tracer.set_process(rank=rank, hostname=socket.gethostname())
        if trace_out:
            trace_out = TR.rank_trace_path(trace_out, rank)
            log(f"(per-rank trace shard: {trace_out})")
    preempt = PreemptionGuard(log=log).install() if args.on_sigterm == "checkpoint" else None
    # the live monitor (train/monitor.py): registry, server, watchdog,
    # heartbeat file, flight recorder, on-demand profiler
    from .train import monitor as MON

    monitor = MON.attach_monitor(
        metrics_port=args.metrics_port, tracer=tracer, preemption=preempt,
        watchdog=args.watchdog == "on",
        config=MON.WatchdogConfig(escalate_after_polls=(
            5 if args.watchdog_escalate == "preempt" and preempt is not None else 0)),
        profile_dir=args.profile_dir or (os.path.dirname(os.path.abspath(trace_out))
                                         if trace_out else None),
        rank=rank, device=device, log=log)
    ending = None
    try:
        try:
            preempted = _steps(args, mesh, log, result, cfg=cfg, params=params, mom=mom,
                               specs=specs, stream=stream, batch_at=batch_at, eval_fn=eval_fn,
                               whole_eval=whole_eval, cards=cards, tracer=tracer,
                               trace_out=trace_out, preempt=preempt, monitor=monitor,
                               rebuild=rebuild)
        except RuntimeError as e:
            if not (os.environ.get(SUPERVISOR_ENV) and joined() and peer_lost(e)):
                raise
            _end_peer_lost(e, monitor.registry, log)
            return "peer_lost"
        if preempted:
            ending = "peer" if preempt.signame == "PEER" else "preempted"
        if monitor.server is not None and args.metrics_linger > 0:
            log(f"(metrics server lingering {args.metrics_linger:g}s for final scrapes)")
            time.sleep(args.metrics_linger)
    finally:
        monitor.close()
        if preempt is not None:
            preempt.uninstall()
    return ending


def _end_peer_lost(exc: RuntimeError, registry, log) -> None:
    """Close a supervised rank whose collective failed because a peer
    process is gone (`peer_lost`): one line, a ``peer_lost`` flight event
    with the last finished step, the run record finalized. No checkpoint:
    its gather would need the lost peer; the newest periodic one stands."""
    from .utils.obs import flight_event

    step = registry.last_step()
    what = (str(exc).strip().splitlines() or [type(exc).__name__])[0][:240]
    log(f"(peer lost after step {step}: {what}; ending as collateral - the supervisor "
        "restarts the group from the newest checkpoint)")
    flight_event("peer_lost", step=step, error=what)
    LEDGER.finalize(metrics={"last_step": step, "preempted": False, "peer_lost": True})


def _restore(args, ck, mesh, log, *, params, mom, specs, mom_specs) -> int:
    """Resume from the newest checkpoint in `ck` into the step's own tensors
    (the JAX CLI's checks of the layout and the cursor); the step to
    continue at (0 without a checkpoint)."""
    peek = ck.latest_meta(log=log)
    if peek is None:
        log(f"(WARNING: --resume found no checkpoint in {args.checkpoint_dir}; starting "
            "from scratch)")
        return 0
    # the layout's checks on the newest meta, before any array is read:
    # mom_format guards against a ZeRO layout from before the per-leaf
    # trees; interleave permutes the layer axis, so a checkpoint of another
    # v holds another layer order (no key: written at v 1)
    meta = peek[1]
    checks = [("mesh", mesh.desc), ("optimizer", args.optimizer)]
    if args.optimizer.startswith("zero"):
        checks.append(("mom_format", MOM_FORMAT))
    if args.pp > 1:
        meta.setdefault("pp_interleave", 1)
        checks.append(("pp_interleave", args.pp_interleave))
    for key, want in checks:
        if meta.get(key) != want:
            raise SystemExit(
                f"checkpoint was written with {key}={meta.get(key)!r}, this run has "
                f"{want!r} - momentum/param shards don't map across layouts; resume with "
                "the original flags, or pass --elastic to reshard the checkpoint onto "
                "this run's layout (parallel/reshard.py)"
                + (" (or restart training: this checkpoint predates the current momentum "
                   "layout)" if key == "mom_format" else ""))
    template = lmtrain.checkpoint_template(params, mom, specs, mom_specs, mesh, args.optimizer)
    state, meta, last = ck.restore_latest(template, log=log)
    try:
        check_cursor(meta, seed=args.seed)
    except ValueError as e:
        raise SystemExit(str(e))
    lmtrain.load_checkpoint_state(state, params, mom, specs, mom_specs, mesh, args.optimizer)
    log(f"(Resumed from step {last}; continuing at {last + 1})")
    return last + 1


def _elastic_restore(args, ck, mesh, log, *, cfg, params, mom, specs, mom_specs, meta,
                     tracer, registry):
    """Restore the newest checkpoint in `ck` onto this run's mesh and
    optimizer through `train/elastic.py` `elastic_restore` (resharded on
    the host when the saved layout differs, then copied into the step's own
    tensors); (last step, the checkpoint's meta, and when it was resharded
    {"seconds", "bytes"}: the whole restore's wall time and the bytes read,
    else None), or None without a checkpoint."""
    from .train import elastic as EL

    t0 = time.perf_counter()
    restored = EL.elastic_restore(
        ck, cfg=cfg, mesh=mesh, specs=specs, optimizer=args.optimizer, current_meta=meta,
        template=lmtrain.checkpoint_template(params, mom, specs, mom_specs, mesh, args.optimizer),
        load=lambda state: lmtrain.load_checkpoint_state(state, params, mom, specs, mom_specs,
                                                         mesh, args.optimizer),
        tracer=tracer, registry=registry, log=log)
    if restored is None:
        return None
    _, meta, last, resharded = restored
    took = None
    if resharded:
        took = {"step": last, "seconds": time.perf_counter() - t0,
                "bytes": ck.last_restore[1]}
    return last, meta, took


def _leave(args, mesh, at_step: int, *, log, ck, run, result, losses, start_step) -> None:
    """Close the run on a rank that an elastic shrink left out: one line,
    the checkpointer, the metrics series and the run record (finalized at
    its last step); the caller's monitor closes on the way out and the
    process exits 0. The rank is in no process group any more."""
    from .utils.obs import flight_event

    survivors = args.chaos_shrink_to * mesh.sp * mesh.tp
    log(f"(elastic: rank {mesh.rank} of {mesh.world} leaves after step {at_step}; "
        + (f"ranks 0-{survivors - 1} continue" if survivors > 1 else "rank 0 continues")
        + " on the shrunk mesh)")
    ck.close()
    run.stop()
    LEDGER.finalize(metrics={"last_step": at_step, "preempted": False, "left_at_shrink": True})
    flight_event("run_end", step=at_step, preempted=False, left=True)
    if result is not None:
        result.update(losses=[float(x) for x in losses], mesh=mesh, start_step=start_step,
                      left=True, step=None)


def _steps(args, mesh, log, result, *, cfg, params, mom, specs, stream, batch_at,
           eval_fn, whole_eval, cards, tracer, trace_out, preempt, monitor, rebuild) -> bool:
    """The training loop with its checkpoints, telemetry and close-out;
    whether a preemption stopped it."""
    from .train import elastic as EL
    from .utils.metrics import init_run
    from .utils.obs import flight_event

    device, pipe = mesh.device, args.pp > 1
    registry = monitor.registry
    m_loss_gauge = registry.gauge("train_loss", "Training loss at the last logged step")
    rows = rebuild.rows(mesh)
    # built here, not by the caller: an in-process shrink must be able to
    # free it (and, under NCCL, its graphs) before the groups go
    step = rebuild.step(mesh, 1.0)

    def state_specs():
        return (ppl.pp_optimizer_state_specs(args.optimizer, specs) if pipe
                else lmtrain.optimizer_state_specs(args.optimizer, specs))

    mom_specs = state_specs()

    def mesh_meta() -> dict:
        """The save-time topology of the CURRENT mesh (read again after an
        in-process shrink: mesh, specs and accum are rebound)."""
        return EL.lm_mesh_meta(mesh, specs, args.optimizer, batch=args.batch_size,
                               accum_steps=args.accum_steps, pp_interleave=args.pp_interleave)

    def ckpt_meta(i: int, loss_val: float) -> dict:
        """The JAX CLI's checkpoint meta, with the exact-resume cursor (every
        batch is a function of (seed, step)) and the save-time topology."""
        return {"mesh": mesh.desc, "optimizer": args.optimizer, "mom_format": MOM_FORMAT,
                "loss": loss_val, "pp_interleave": args.pp_interleave,
                "mesh_meta": mesh_meta(), **resume_cursor(step=i, seed=args.seed)}

    def save(i: int, loss) -> None:
        ck.save(i, lmtrain.checkpoint_state(params, mom, specs, mom_specs, mesh,
                                            args.optimizer), ckpt_meta(i, float(loss)))

    ck = None
    step0 = 0
    reshards = []  # the elastic restores' {"step", "seconds", "bytes"}
    if args.checkpoint_dir:
        from .utils.checkpoint import TreeCheckpointer

        ck = TreeCheckpointer(args.checkpoint_dir, registry=registry)
        if not args.resume and ck.latest_step() is not None:
            raise SystemExit(
                f"--checkpoint-dir {args.checkpoint_dir} already contains checkpoints "
                f"(latest step {ck.latest_step()}); pass --resume to continue that run or "
                "use a fresh directory (saves at existing step numbers would be silently "
                "skipped)")
        if args.resume and args.elastic:
            restored = _elastic_restore(args, ck, mesh, log, cfg=cfg, params=params, mom=mom,
                                        specs=specs, mom_specs=mom_specs, meta=mesh_meta(),
                                        tracer=tracer, registry=registry)
            if restored is None:
                log(f"(WARNING: --resume found no checkpoint in {args.checkpoint_dir}; "
                    "starting from scratch)")
            else:
                last, meta, took = restored
                resharded = took is not None
                if resharded:
                    reshards.append(took)
                try:
                    check_cursor(meta, seed=args.seed)
                except ValueError as e:
                    raise SystemExit(str(e))
                step0 = last + 1
                if resharded and not pipe:
                    new_accum = EL.rescaled_accum_steps(
                        meta.get("mesh_meta") or {}, batch=args.batch_size, new_dp=args.dp,
                        accum_steps=args.accum_steps)
                    if new_accum != args.accum_steps:
                        log(f"(elastic: accum-steps {args.accum_steps} -> {new_accum} keeps the "
                            f"global batch {args.batch_size} - and with it the data cursor - "
                            "exact across the dp change)")
                        args.accum_steps = new_accum
                        # not yet called, so not yet captured: built again
                        step = rebuild.step(mesh, 1.0)
                log(f"(Resumed from step {last}; continuing at {step0})")
        elif args.resume:
            step0 = _restore(args, ck, mesh, log, params=params, mom=mom, specs=specs,
                             mom_specs=mom_specs)
    tokens, targets = rows(*rebuild.host_batch)

    run = init_run(jsonl_path=args.metrics_jsonl, rank=mesh.rank if mesh.joined else None)
    run["parameters"] = {
        "mesh": mesh.desc, "optimizer": args.optimizer, "lr": args.lr,
        "lr_schedule": args.lr_schedule, "batch_size": args.batch_size,
        "seq_len": args.seq_len, "d_model": args.d_model, "n_layers": args.n_layers,
        "dtype": args.dtype,
    }
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    tokens_per_step = args.batch_size * args.seq_len
    stats = None
    if args.trace_out or args.step_stats:
        from .parallel.collectives import plan_buckets

        # the gradient sync rides the (data, seq) axes
        n_sync = mesh.dp * mesh.sp
        overlap = args.grad_sync == "overlap" and args.accum_steps > 1
        bucket_bytes = None
        if overlap:
            layout = plan_buckets(lmtrain.tree_leaves(params),
                                  bucket_bytes=int(args.bucket_mb * 2**20),
                                  group_keys=[str(x) for x in lmtrain.tree_leaves(specs)])
            bucket_bytes = [int(b) for b in layout.bucket_bytes()]
            comm = TR.overlapped_collective_bytes(bucket_bytes, n_sync, args.accum_steps)
        else:
            comm = TR.collective_bytes_per_sync(params, n_sync)
        stats = TR.StepStats(
            item_label="tokens", sink=run if args.step_stats else None, n_devices=cards,
            comm_bytes_per_step=comm, grad_sync=args.grad_sync, comm_bucket_bytes=bucket_bytes,
            flops_per_step=model_flops_per_token(cfg, args.seq_len) * tokens_per_step,
            flops_source="analytic", peak_flops_per_device=peak_flops(kind, args.dtype),
            registry=registry)
        if overlap and tracer.enabled:
            TR.record_bucket_plan(
                tracer, bucket_bytes, schedule="overlap", axis_size=n_sync,
                op="reduce_scatter" if args.optimizer.startswith("zero") else "psum",
                accum_steps=args.accum_steps)
    # telemetered (a trace, StepStats, a metrics server or a heartbeat
    # file): every step fenced and recorded; the bare path attributes its
    # window coarsely at the end (fencing each step would change it)
    telemetered = (stats is not None or monitor.server is not None
                   or monitor.heartbeat is not None)

    def wrap_step(first_step: int):
        """The step with its spans, StepStats, ledger intervals and live
        metrics, step numbers counted from `first_step` (again after a
        rollback); the recompile detector re-baselined on it first."""
        if monitor.recompiles is not None:
            monitor.recompiles.swap(step)
        if not telemetered:
            return step
        return lmtrain.make_traced_step(step, tracer=tracer, step_stats=stats,
                                        items_per_step=tokens_per_step, first_step=first_step,
                                        registry=registry, recompiles=monitor.recompiles)

    run_step = wrap_step(step0)

    # the self-healing layer (train/guard.py) and its fault injection
    rank = mesh.rank if mesh.joined else None
    monkey = None
    stall_at = tuple(args.chaos_stall_step or ())
    if stall_at and args.chaos_stall_rank is not None and (rank or 0) != args.chaos_stall_rank:
        stall_at = ()  # this rank is not the designated straggler
    if (args.chaos_spike_step or stall_at or args.chaos_sigterm_after is not None
            or args.chaos_shrink_at_step is not None):
        from .parallel.fault import ChaosMonkey

        monkey = ChaosMonkey(spike_at=tuple(args.chaos_spike_step or ()),
                             sigterm_after=args.chaos_sigterm_after, stall_at=stall_at,
                             stall_s=args.chaos_stall_seconds,
                             shrink_at=args.chaos_shrink_at_step, preempt=preempt,
                             tracer=tracer, log=log)
    guard = hpipe = None
    if args.guard != "off":
        guard = G.TrainingGuard(
            G.GuardConfig(policy=args.guard, spike_zscore=args.guard_spike_zscore,
                          snapshot_every=args.snapshot_every, max_retries=args.max_retries),
            tracer=tracer, step_stats=stats, registry=registry, log=log)
        hpipe = G.HealthPipe(guard, perturb=monkey.perturb if monkey is not None else None)
    # the guard's snapshot and restore costs (seconds, bytes), for callers
    guard_io = {"snapshots": [], "restores": []}

    ema = ema_fn = None
    leaves = lmtrain.tree_leaves(params)
    if args.ema_decay:
        # from the restored parameters: the average is not checkpointed
        ema_fn = make_ema_update(args.ema_decay)
        ema = [x.detach().clone() for x in leaves]
    end_step = args.stop_at_step if args.stop_at_step is not None else step0 + args.steps
    first_loss = t0 = last_eval = None
    eval_s, timed_steps = 0.0, 0
    t_first = time.perf_counter()
    loss = None
    losses = []
    preempted = False
    last_step = step0 - 1
    saved_at = None

    def snapshot_tree():
        # the checkpoint's whole tree (a gather every rank makes)
        return lmtrain.checkpoint_state(params, mom, specs, mom_specs, mesh, args.optimizer)

    def handle_verdict(v) -> bool:
        """Apply a guard verdict; True = rolled back (the loop continues at
        the snapshot's step, the step's lr backed off)."""
        nonlocal run_step, i
        if v is None or v.action in ("ok", "warn", "skip"):
            return False
        # at_step sizes the ledger's rollback_recompute window; raises
        # GuardAbort when the retry budget is spent
        rb = guard.rollback(at_step=i)
        if rb is None and ck is not None:
            # no snapshot yet: the newest checkpoint on disk (the same
            # exact-resume contract)
            restored = ck.restore_latest(lmtrain.checkpoint_template(
                params, mom, specs, mom_specs, mesh, args.optimizer), log=log)
            if restored is not None:
                state, _meta, last = restored
                rb = (last + 1, state)
                if i > last + 1:
                    LEDGER.mark_recompute(i - (last + 1))
                log(f"(guard: no snapshot yet; restored the on-disk checkpoint at step {last})")
        if rb is None:
            raise G.GuardAbort(
                "guard rollback requested before any snapshot or on-disk checkpoint exists - "
                "lower the LR, enable --checkpoint-dir, or start with --guard warn to observe "
                "first")
        snap_step, state = rb
        t_r = time.perf_counter()
        # into the step's own tensors: its captured program is kept
        lmtrain.load_checkpoint_state(state, params, mom, specs, mom_specs, mesh,
                                      args.optimizer)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        guard_io["restores"].append(time.perf_counter() - t_r)
        # the lr backoff: the step reads its lr from a buffer at every call,
        # so the schedule's base lr is scaled and the program kept
        step.lr = args.lr * guard.lr_scale
        step.lr_schedule = schedule_at(args, guard.lr_scale)
        run_step = wrap_step(snap_step)
        log(f"(guard: resuming from step {snap_step} at lr_scale={guard.lr_scale:g} "
            "[the captured step kept, its lr buffer rescaled])")
        hpipe.clear()
        del losses[max(snap_step - step0, 0):]
        i = snap_step
        return True

    def do_elastic_shrink(new_dp: int, at_step: int) -> bool:
        """Answer a SHRINK preemption in process (the emergency checkpoint
        is on disk): free the step's programs, re-form the process group
        over the first new_dp x sp x tp ranks (`shrink_group`; False on a
        rank that leaves), build the survivors' mesh, state and step,
        reshard the checkpoint onto them (the same `elastic_restore` a
        fresh process takes), re-slice the gradient accumulation so the
        global batch and the data cursor stay exact, and continue."""
        nonlocal mesh, params, mom, specs, mom_specs, step, run_step, rows, tokens, targets
        nonlocal leaves, ema, cards
        from .parallel.distributed import shrink_group
        from .parallel.reshard import rescale_accum

        old_dp = mesh.dp
        whole_ema = None
        if ema is not None:
            # the average is not checkpointed: its whole tree crosses on the host
            whole_ema = tfm.to_numpy(lmtrain.gather_params(
                lmtrain.tree_unflatten(params, ema), specs, mesh))
        # the step's programs (under NCCL, graphs over the old groups' collectives)
        # go before the groups
        step = run_step = None
        if monitor.recompiles is not None:
            monitor.recompiles.swap(None)
        gc.collect()
        if not shrink_group(new_dp * mesh.sp * mesh.tp, device=device):
            return False
        mesh = lmtrain.create_lm_mesh(new_dp, args.sp, args.tp, device=device)
        args.accum_steps = rescale_accum(args.batch_size, old_dp, new_dp, args.accum_steps)
        args.dp = new_dp
        params, specs, mom = rebuild.state(mesh)
        mom_specs = state_specs()
        reshards.append(_elastic_restore(
            args, ck, mesh, log, cfg=cfg, params=params, mom=mom, specs=specs,
            mom_specs=mom_specs, meta=mesh_meta(), tracer=tracer, registry=registry)[2])
        step = rebuild.step(mesh, guard.lr_scale if guard is not None else 1.0)
        run_step = wrap_step(at_step + 1)
        leaves = lmtrain.tree_leaves(params)
        if whole_ema is not None:
            ema = [x.to(device) for x in lmtrain.tree_leaves(
                lmtrain.shard_params(tfm.from_jax_params(whole_ema), cfg, mesh)[0])]
        cards = _cards(mesh)
        rows = rebuild.rows(mesh)
        tokens, targets = rows(*rebuild.host_batch)
        if guard is not None:
            # the rolling snapshot holds the old layout; the next cadence retakes it
            guard.drop_snapshot()
        if hpipe is not None:
            hpipe.clear()
        log(f"(elastic: continuing at step {at_step + 1} on mesh {mesh.desc}, "
            f"accum_steps={args.accum_steps})")
        return True

    i = step0
    while i < end_step:
        if guard is not None and (i - step0) % args.snapshot_every == 0:
            # settle the observation in flight before the snapshot, so that
            # it only ever holds state the guard has judged
            if handle_verdict(hpipe.flush()):
                continue
            t_s = time.perf_counter()
            if guard.maybe_snapshot(i, snapshot_tree, first_step=step0):
                guard_io["snapshots"].append((i, time.perf_counter() - t_s, sum(
                    x.nbytes if isinstance(x, np.ndarray) else x.numel() * x.element_size()
                    for x in lmtrain.tree_leaves(guard.peek_snapshot()[1]))))
        if stream is not None:
            # host-side sampling blocks the loop: data_wait
            with LEDGER.interval("data_wait"):
                tokens, targets = rows(*batch_at(i))
        out = run_step(params, mom, tokens, targets, i)
        loss = out[0] if guard is not None else out
        # the ranks agree on a stop while the card runs the step just
        # launched (a host-side all-reduce: it waits for no card)
        stop = preempt is not None and preempt.agreed()
        # the previous step's health, read now that this one is launched
        if hpipe is not None and handle_verdict(hpipe.push(i, out[1])):
            continue
        if result is not None:
            losses.append(loss)
        if ema_fn is not None:
            ema_fn(ema, leaves)
        if eval_fn is not None and (i + 1) % args.eval_every == 0:
            t_ev = time.perf_counter()
            eval_params = lmtrain.tree_unflatten(params, ema) if ema is not None else params
            # the eval program's capture is compile time
            with (LEDGER.interval("compile") if eval_fn.program is None
                  else contextlib.nullcontext()):
                # the same value on every rank (the whole held-out batch on
                # each, or the shards' mean)
                ev = float(np.mean([float(eval_fn(eval_params,
                                                  *rows(*batch_at(j, "eval"),
                                                        whole_batch=whole_eval)))
                                    for j in range(args.eval_batches)]))
            if t0 is not None:
                eval_s += time.perf_counter() - t_ev
            last_eval = {"step": i, "eval_loss": round(ev, 4),
                         "ppl": round(float(np.exp(min(ev, 30.0))), 2)}
            log(f"step {i:>5}  eval_loss {ev:.4f}  ppl {last_eval['ppl']:.2f}")
            run.append("val/loss", ev)
        if i == step0 and first_loss is None:
            first_loss = float(loss)  # waits for the step
            log(f"(first step incl. kernel build and graph capture: "
                f"{time.perf_counter() - t_first:.1f}s)")
            log(f"(step program: {step.segments})")
            t0 = time.perf_counter()
        elif t0 is not None:
            timed_steps += 1
        if (i - step0) % args.log_every == 0 or i == end_step - 1:
            loss_val = float(loss)
            log(f"step {i:>5}  loss {loss_val:.4f}")
            run.append("train/loss", loss_val)
            m_loss_gauge.set(loss_val)
        if ck is not None and (i + 1) % args.checkpoint_every == 0:
            save(i, loss)
            saved_at = i
        last_step = i
        if monkey is not None:
            monkey.after_step(i)
            if monkey.shrink_at == i:
                # every rank raised it after this step: agreed now, not at the next launch
                stop = preempt.agreed()
        if stop:
            if ck is not None and saved_at != i:
                save(i, loss)
                saved_at = i
            if monkey is not None and monkey.shrink_at == i and ck is not None:
                # elastic path: the emergency checkpoint is the hand-off;
                # reshard it onto the surviving ranks and keep training
                log(f"(emergency checkpoint at step {i}; SHRINK preemption -> resharding "
                    "onto the surviving ranks)")
                old_mesh = mesh
                if not do_elastic_shrink(args.chaos_shrink_to, i):
                    _leave(args, old_mesh, i, log=log, ck=ck, run=run, result=result,
                           losses=losses, start_step=step0)
                    return False
                preempt.requested = False
                preempt.signame = None
                i += 1
                continue
            preempted = True
            if ck is not None:
                log(f"(emergency checkpoint at step {i}; resume with --resume to continue "
                    "bit-exactly)")
            else:
                log(f"({preempt.signame}: stopping after step {i}; no --checkpoint-dir, "
                    "progress is lost)")
            break
        i += 1
    if hpipe is not None:
        # the last step's verdict (the counters and the trace complete; a
        # final-step rollback has nothing left to run again, and the abort
        # policy still raises from here)
        hpipe.flush()
    if loss is None:
        # resumed at or past the stop step: nothing to train
        log(f"(stop-at-step {end_step} already reached - resumed at step {step0}; nothing "
            "to do)")
        if ck is not None:
            ck.close()
        run.stop()
        LEDGER.finalize(metrics={"last_step": step0 - 1, "nothing_to_do": True})
        return False
    final_loss = float(loss)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if not telemetered and t0 is not None:
        # the bare path's coarse attribution: the first step (the kernels'
        # build and the capture) as compile, the rest as a steady fill that
        # the checkpoint saves inside it carve out of
        now_l, pc = LEDGER.now(), time.perf_counter()
        LEDGER.add("compile", now_l - (pc - t_first), now_l - (pc - t0))
        LEDGER.fill_ending_now("steady_step", max(pc - t0 - eval_s, 0.0))
        LEDGER.note_steps(timed_steps, tokens=float(tokens_per_step * timed_steps))
    if ck is not None:
        if not preempted and saved_at != last_step:
            save(last_step, loss)
        ck.close()
    dt = _group_max(time.perf_counter() - t0 - eval_s if timed_steps else 0.0, mesh)
    tok_s = tokens_per_step * timed_steps / dt if dt else 0.0
    flops_tok = model_flops_per_token(cfg, args.seq_len)
    model_flops_s = flops_tok * tok_s
    peak = peak_flops(kind, args.dtype)
    mfu = model_flops_s / (peak * cards) * 100.0 if peak else None
    if mfu is not None:
        log(f"MFU {mfu:.1f}% = {model_flops_s / 1e12:.1f} model TFLOP/s / ({peak / 1e12:.0f} "
            f"peak {'bf16' if args.dtype == 'bfloat16' else 'f32'} TFLOP/s x {cards} dev, "
            f"{kind}); FLOPs/token = 3*(L*(8d^2 + 4sd + 4d*ff) + 2d*V) = "
            f"{flops_tok / 1e6:.1f}M")
    if args.generate > 0 and pipe:
        log("(--generate skipped: decode needs the non-pipeline param layout; rerun without "
            "--pp)")
    elif args.generate > 0:
        gen_params = lmtrain.tree_unflatten(params, ema) if ema is not None else params
        if mesh.tp > 1 or lmtrain.expert_axis(cfg, mesh):
            gen_params = lmtrain.gather_params(gen_params, specs, mesh)
        ptoks, _ = lmtrain.make_copy_task(
            torch.Generator().manual_seed(args.seed + 1), batch=args.batch_size,
            seq_len=args.seq_len, vocab=args.vocab, device=device)
        half = args.seq_len // 2
        out = tfm.generate(
            gen_params, ptoks[:2, : half + 1], cfg, max_new_tokens=args.generate,
            temperature=args.gen_temperature, top_k=args.gen_top_k, top_p=args.gen_top_p,
            generator=(torch.Generator().manual_seed(args.seed + 2)
                       if args.gen_temperature > 0 else None))
        for j, row in enumerate(out.tolist()):
            log(f"gen[{j}] prompt={row[:half + 1]} completion={row[half + 1:]}")
    # goodput close-out: conservation asserted, the record written when armed
    goodput_rec = LEDGER.finalize(metrics={
        "final_loss": final_loss, "first_loss": first_loss, "last_step": last_step,
        "preempted": preempted, "tokens_per_s": round(tok_s),
        "mfu_pct": round(mfu, 2) if mfu is not None else None,
    })
    if stats is not None:
        stats.capture_memory(tracer)
        if args.step_stats:
            for line in stats.report().splitlines():
                log(line)
    if trace_out:
        tracer.export(trace_out, step_stats=stats, goodput=goodput_rec)
        log(f"(Chrome trace written to {trace_out}; open in Perfetto / chrome://tracing, or "
            "summarize with tools/trace_summary.py)")
    run.stop()
    if guard is not None:
        log("(guard summary: " + json.dumps(guard.summary()) + ")")
    log("GOODPUT " + json.dumps({
        "goodput_ratio": goodput_rec["goodput_ratio"], "wall_s": goodput_rec["wall_s"],
        "goodput_s": goodput_rec["goodput_s"],
        "badput_s": {k: v for k, v in goodput_rec["badput_s"].items() if v > 0},
        "steps": goodput_rec["steps"], "record": LEDGER.path,
    }))
    summary = dict.fromkeys(SUMMARY_KEYS)
    summary.update({
        "mesh": mesh.desc, "steps": args.steps, "start_step": step0, "last_step": last_step,
        "preempted": preempted, "guard": args.guard,
        "guard_summary": guard.summary() if guard is not None else None, "dtype": args.dtype,
        # (P-1)/(v*M+P-1) of tick-time processes garbage
        "pp_bubble_frac": (round((args.pp - 1) / (args.pp_interleave * args.microbatches
                                                 + args.pp - 1), 4) if pipe else None),
        "grad_sync": args.grad_sync,
        "accum_steps": args.accum_steps,
        "data_source": stream.source if stream is not None else "copy-task",
        "eval": last_eval, "first_loss": first_loss, "final_loss": final_loss,
        "tokens_per_s": round(tok_s), "wall_s_post_compile": round(dt, 3),
        "model_tflops_per_s": round(model_flops_s / 1e12, 2),
        "mfu_pct": round(mfu, 2) if mfu is not None else None,
    })
    log("SUMMARY " + json.dumps(summary))
    flight_event("run_end", step=last_step, preempted=preempted)
    if isinstance(mom, dict) and "t" in mom:
        mom["t"] = lmtrain.adam_count(mom)  # the exact count, for callers
    if result is not None:
        result.update(losses=[float(x) for x in losses], params=params, mom=mom, step=step,
                      left=False, reshards=reshards,
                      mesh=mesh, cards=cards, specs=specs, start_step=step0,
                      guard=None if guard is None else {**guard.summary(), **guard_io},
                      checkpoint=None if ck is None else {"save": ck.last_save,
                                                          "restore": ck.last_restore})
    return preempted


def cli() -> int:
    """`main` on ``sys.argv``, a guard abort turned into one line and a
    nonzero exit (the JAX CLI's)."""
    try:
        return main()
    except G.GuardAbort as e:
        # one actionable line instead of a traceback: the message says what
        # happened and what to do next
        raise SystemExit(f"GUARD ABORT: {e}")


if __name__ == "__main__":
    import sys

    sys.exit(cli())
