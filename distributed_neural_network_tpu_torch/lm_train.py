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
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from .device import resolve_device
from .models import transformer as tfm
from .ops.schedule import make_ema_update, warmup_cosine
from .parallel.distributed import distribute_host_data, initialize, joined
from .parallel import pipeline as ppl
from .parallel.ring import zigzag_order
from .train import lm as lmtrain
from .train.cli import SLICE5, say
from .train.engine import SLICE4
from .train.measure import model_flops_per_token, peak_flops

# the keys of the JAX CLI's SUMMARY line, in its order
SUMMARY_KEYS = (
    "mesh", "steps", "start_step", "last_step", "preempted", "guard", "guard_summary",
    "dtype", "pp_bubble_frac", "grad_sync", "accum_steps", "dynamics", "data_source", "eval",
    "first_loss", "final_loss", "tokens_per_s", "wall_s_post_compile", "model_tflops_per_s",
    "mfu_pct",
)

# dest -> (flag, the slice that brings it); each is parsed with default None
LATER_FLAGS = {
    "stop_at_step": ("--stop-at-step", SLICE4),
    "metrics_jsonl": ("--metrics-jsonl", SLICE4),
    "run_record": ("--run-record", SLICE4),
    "trace_out": ("--trace-out", SLICE4),
    "step_stats": ("--step-stats", SLICE4),
    "dynamics": ("--dynamics", SLICE4),
    "dynamics_jsonl": ("--dynamics-jsonl", SLICE4),
    "metrics_port": ("--metrics-port", SLICE4),
    "metrics_linger": ("--metrics-linger", SLICE4),
    "profile_dir": ("--profile-dir", SLICE4),
    "watchdog": ("--watchdog", SLICE4),
    "watchdog_escalate": ("--watchdog-escalate", SLICE4),
    "checkpoint_dir": ("--checkpoint-dir", SLICE4),
    "checkpoint_every": ("--checkpoint-every", SLICE4),
    "resume": ("--resume", SLICE4),
    "elastic": ("--elastic", SLICE4),
    "guard": ("--guard", SLICE4),
    "guard_spike_zscore": ("--guard-spike-zscore", SLICE4),
    "snapshot_every": ("--snapshot-every", SLICE4),
    "max_retries": ("--max-retries", SLICE4),
    "on_sigterm": ("--on-sigterm", SLICE4),
    "chaos_nan_step": ("--chaos-nan-step", SLICE4),
    "chaos_nan_layer": ("--chaos-nan-layer", SLICE4),
    "chaos_spike_step": ("--chaos-spike-step", SLICE4),
    "chaos_sigterm_after": ("--chaos-sigterm-after", SLICE4),
    "chaos_stall_step": ("--chaos-stall-step", SLICE4),
    "chaos_stall_seconds": ("--chaos-stall-seconds", SLICE4),
    "chaos_stall_rank": ("--chaos-stall-rank", SLICE4),
    "chaos_shrink_at_step": ("--chaos-shrink-at-step", SLICE4),
    "chaos_shrink_to": ("--chaos-shrink-to", SLICE4),
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
    for dest, (flag, later) in LATER_FLAGS.items():
        p.add_argument(flag, dest=dest, nargs="?", const=True, default=None,
                       help=f"not ported yet: {later}")
    return p


def validate(p: argparse.ArgumentParser, args) -> None:
    """The JAX CLI's argument checks that apply on one device."""
    if args.steps < 1:
        p.error("--steps must be >= 1")
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
    callers that drive the entry point in-process."""
    p = build_parser()
    args = p.parse_args(argv)
    validate(p, args)
    check_ported(args)
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
        _train(args, mesh, log, result)
    finally:
        if owned and joined():
            # the step's graphs (and their NCCL collectives) go first
            gc.collect()
            dist.destroy_process_group()
    return 0


def _train(args, mesh, log, result) -> None:
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
    if pipe:
        params, specs = ppl.shard_pp_params(whole, cfg, mesh, interleave=args.pp_interleave)
    else:
        params, specs = lmtrain.shard_params(whole, cfg, mesh, rules=rules)
    del whole
    if pipe and args.optimizer.startswith("zero"):
        mom = ppl.init_pp_zero_state(params, mesh, args.optimizer)
    else:
        mom = lmtrain.init_lm_momentum(params, args.optimizer, mesh)
    cards = _cards(mesh)
    lr_schedule = None
    if args.lr_schedule == "cosine":
        lr_schedule = functools.partial(warmup_cosine, base_lr=args.lr, total_steps=args.steps,
                                        warmup_steps=args.warmup_steps,
                                        min_lr_frac=args.min_lr_frac)
    if pipe:
        step = ppl.make_pp_train_step(
            cfg, mesh, device=device, n_microbatches=args.microbatches, lr=args.lr,
            momentum=args.momentum, loss_chunks=args.loss_chunks,
            interleave=args.pp_interleave, lr_schedule=lr_schedule, clip_norm=args.clip_norm,
            weight_decay=args.weight_decay, optimizer=args.optimizer,
            accum_steps=args.accum_steps, grad_sync=args.grad_sync, bucket_mb=args.bucket_mb)
    else:
        step = lmtrain.make_lm_train_step(
            cfg, mesh=mesh, device=device, lr=args.lr, momentum=args.momentum,
            attn_impl=args.attn, optimizer=args.optimizer, loss_chunks=args.loss_chunks,
            lr_schedule=lr_schedule, clip_norm=args.clip_norm, accum_steps=args.accum_steps,
            weight_decay=args.weight_decay, grad_sync=args.grad_sync, bucket_mb=args.bucket_mb,
            rules=rules,
        )

    zperm = None
    if args.attn == "zigzag" and args.sp > 1:
        # the zigzag layout: each sequence rank's shard holds one early and
        # one late chunk; the loss is a mean over positions, so one
        # permutation of tokens and targets leaves it unchanged
        zperm = torch.from_numpy(zigzag_order(args.seq_len, args.sp)).long()

    def rows(tok, tgt, whole_batch=False):
        """This rank's block of the global batch (the batch itself at 1 x 1
        x 1): its rows and sequence columns, or (`whole_batch`, an eval
        batch off the pipeline and off expert parallelism) every row and
        its columns. The pipeline's eval, and the eval under expert
        parallelism, take their data shard's rows, as their step."""
        if zperm is not None:
            tok, tgt = tok[:, zperm], tgt[:, zperm]
        return tuple(distribute_host_data(x, mesh, device=device, rows=not whole_batch)
                     for x in (tok, tgt))

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

        tokens, targets = rows(*batch_at(0))
    else:
        tokens, targets = rows(*lmtrain.make_copy_task(
            torch.Generator().manual_seed(args.seed + 1), batch=args.batch_size,
            seq_len=args.seq_len, vocab=args.vocab))
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
        sync = f", collectives {step.collective_form}"
    log(f"(LM {n_params:,} params, mesh {mesh.desc}, "
        f"attn={args.attn if args.sp > 1 or args.attn == 'flash' else 'full'}, "
        + (f"precision={args.precision}, " if args.precision != "bf16" else "")
        + f"experts={args.experts or 'dense'}, optimizer={args.optimizer}, "
        f"grad_sync={args.grad_sync}, "
        f"device={device}{sync})")

    ema = ema_fn = None
    leaves = lmtrain.tree_leaves(params)
    if args.ema_decay:
        ema_fn = make_ema_update(args.ema_decay)
        ema = [x.detach().clone() for x in leaves]
    first_loss = t0 = last_eval = None
    eval_s, timed_steps = 0.0, 0
    t_first = time.perf_counter()
    loss = None
    losses = []
    for i in range(args.steps):
        if stream is not None:
            tokens, targets = rows(*batch_at(i))
        loss = step(params, mom, tokens, targets, i)
        if result is not None:
            losses.append(loss)
        if ema_fn is not None:
            ema_fn(ema, leaves)
        if eval_fn is not None and (i + 1) % args.eval_every == 0:
            t_ev = time.perf_counter()
            eval_params = lmtrain.tree_unflatten(params, ema) if ema is not None else params
            # the same value on every rank (the whole held-out batch on each, or
            # the shards' mean)
            ev = float(np.mean([float(eval_fn(eval_params, *rows(*batch_at(j, "eval"),
                                                                whole_batch=whole_eval)))
                                for j in range(args.eval_batches)]))
            if t0 is not None:
                eval_s += time.perf_counter() - t_ev
            last_eval = {"step": i, "eval_loss": round(ev, 4),
                         "ppl": round(float(np.exp(min(ev, 30.0))), 2)}
            log(f"step {i:>5}  eval_loss {ev:.4f}  ppl {last_eval['ppl']:.2f}")
        if i == 0:
            first_loss = float(loss)  # waits for the step
            log(f"(first step incl. kernel build and graph capture: "
                f"{time.perf_counter() - t_first:.1f}s)")
            log(f"(step program: {step.segments})")
            t0 = time.perf_counter()
        else:
            timed_steps += 1
        if i % args.log_every == 0 or i == args.steps - 1:
            log(f"step {i:>5}  loss {float(loss):.4f}")
    final_loss = float(loss)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = _group_max(time.perf_counter() - t0 - eval_s if timed_steps else 0.0, mesh)
    tok_s = args.batch_size * args.seq_len * timed_steps / dt if dt else 0.0
    flops_tok = model_flops_per_token(cfg, args.seq_len)
    model_flops_s = flops_tok * tok_s
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
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
    summary = dict.fromkeys(SUMMARY_KEYS)
    summary.update({
        "mesh": mesh.desc, "steps": args.steps, "start_step": 0, "last_step": args.steps - 1,
        "preempted": False, "guard": "off", "dtype": args.dtype,
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
    if result is not None:
        result.update(losses=[float(x) for x in losses], params=params, mom=mom, step=step,
                      mesh=mesh, cards=cards, specs=specs)


if __name__ == "__main__":
    import sys

    sys.exit(main())
