"""launch: spawn and supervise an elastic multi-process training group.

The single-node elastic supervisor (`train/supervisor.py`) as a CLI: N real
OS processes join one torch.distributed process group through torchrun's
environment (`parallel/distributed.py` `initialize()` - the supervisor owns
the port), each worker's liveness rides a heartbeat file, and on a worker
death the group restarts with the survivors - an ``lm_train --resume
--elastic`` workload then reshards the newest consistent checkpoint onto the
smaller mesh and keeps training. When capacity returns, `--grow-after`
rejoins it.

The worker command follows `--`; every argv element may carry the tokens
`{rank}` / `{nprocs}` / `{devices}` (current group size x
--devices-per-proc, which is 1: a torch rank drives one device),
re-substituted on every (re)launch.

Examples:
  # 2 ranks sharing one card (gloo), the flagship LM, survives one induced
  # SIGKILL at step 3
  python -m distributed_neural_network_tpu_torch.launch --nprocs 2 \\
      --chaos-kill-rank 1 --chaos-kill-at-step 3 --chaos-kill-signal KILL \\
      -- python -m distributed_neural_network_tpu_torch.lm_train --dp "{devices}" \\
         --attn flash --steps 6 --stop-at-step 6 --checkpoint-dir ck \\
         --checkpoint-every 2 --resume --elastic

  # coordinator death (rank 0 hosts the TCPStore at MASTER_PORT)
  python -m distributed_neural_network_tpu_torch.launch --nprocs 2 \\
      --chaos-kill-rank 0 --chaos-kill-at-step 3 -- python -m ...lm_train ...

Exit codes: 0 = the group completed; 3 = restart budget exhausted /
below --min-procs (SUPERVISOR ABORT names the last failure); 4 =
rendezvous never succeeded. One machine-readable
`SUPERVISOR_SUMMARY {json}` line is always printed. Every failure
restart (and any abort) also writes `<run-dir>/postmortem.json` - the
per-rank exit causes, last heartbeats, crash flight-recorder dumps, and
log tails of the generation that died.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, command = argv[:split], argv[split + 1:]
    else:
        command = []
    p = argparse.ArgumentParser(
        prog="python -m distributed_neural_network_tpu_torch.launch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--nprocs", type=int, required=True,
                   help="target worker-process count")
    p.add_argument("--devices-per-proc", type=int, default=1,
                   help="devices each worker drives: 1 (a torch rank drives "
                   "one device; a larger value is refused - run one worker a "
                   "card with --nprocs)")
    p.add_argument("--no-force-host-devices", action="store_true",
                   help="accepted for the JAX launcher's command lines; torch "
                   "workers read no XLA_FLAGS, so it changes nothing")
    p.add_argument("--min-procs", type=int, default=1,
                   help="smallest group the supervisor will shrink to; "
                   "fewer survivors than this aborts")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="failure-restart budget for the whole run; "
                   "exhausted = SUPERVISOR ABORT, exit 3 (no crash loop)")
    p.add_argument("--restart-backoff", type=float, default=1.0,
                   metavar="SEC", help="base backoff between failure "
                   "restarts (doubles per restart, capped at 30s)")
    p.add_argument("--rendezvous-retries", type=int, default=2,
                   help="relaunches (fresh coordinator port) for groups "
                   "that die before every worker came up")
    p.add_argument("--rendezvous-timeout", type=float, default=120.0,
                   metavar="SEC", help="group must finish rendezvous "
                   "(every worker heartbeating) within this window")
    p.add_argument("--grace", type=float, default=10.0, metavar="SEC",
                   help="SIGTERM -> SIGKILL grace when stopping workers "
                   "(long enough for an emergency checkpoint)")
    p.add_argument("--failure-settle", type=float, default=0.5,
                   metavar="SEC",
                   help="after a worker death is detected, wait this long "
                   "(or until the group is fully down) before freezing "
                   "the failure set - a gang crash then restarts "
                   "same-size instead of being misread as partial")
    p.add_argument("--heartbeat-timeout", type=float, default=0.0,
                   metavar="SEC",
                   help="treat a worker whose training heartbeat is this "
                   "stale as dead (0 = exit codes only; the in-process "
                   "watchdog handles stalls by default)")
    p.add_argument("--grow-after", type=float, default=0.0, metavar="SEC",
                   help="after a shrunk group has been healthy this long, "
                   "restart at full size (planned, graceful - every "
                   "worker checkpoints first); 0 = never grow")
    p.add_argument("--poll", type=float, default=0.2, metavar="SEC")
    p.add_argument("--run-dir", default=None,
                   help="supervisor state dir (heartbeats, worker logs); "
                   "default ./supervisor_run")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve the SUPERVISOR's live metrics "
                   "(supervisor_group_size, worker_failures_total, "
                   "elastic_restarts_total, restart latency) PLUS the "
                   "federated fleet view - per-rank step/step-time "
                   "gauges, fleet_step_skew_seconds, fleet_straggler_rank "
                   "and, for workers started with their own "
                   "--metrics-port, scraped rank-labeled fleet_* "
                   "re-exports - on http://127.0.0.1:PORT/metrics; 0 = "
                   "ephemeral. Watch with tools/live_top.py (fleet view)")
    p.add_argument("--scrape-interval", type=float, default=2.0,
                   metavar="SEC",
                   help="how often the supervisor scrapes each worker's "
                   "/metrics endpoint for the federation (workers "
                   "advertise their URL in the heartbeat file; heartbeat-"
                   "derived fleet metrics flow regardless)")
    p.add_argument("--straggler-min-skew", type=float, default=0.25,
                   metavar="SEC",
                   help="smallest cross-rank step-arrival spread that "
                   "attributes a straggler (fleet_straggler_rank); "
                   "smaller spreads are lockstep noise at the poll "
                   "cadence and set the gauge to -1")
    p.add_argument("--chaos-kill-rank", type=int, action="append",
                   default=None, metavar="R",
                   help="fault injection (parallel/fault.py ProcessChaos): "
                   "kill worker R once its heartbeat reaches "
                   "--chaos-kill-at-step (repeatable, paired positionally "
                   "with the other --chaos-kill-* flags; rank 0 = "
                   "coordinator death)")
    p.add_argument("--chaos-kill-at-step", type=int, action="append",
                   default=None, metavar="N",
                   help="step threshold for the matching --chaos-kill-rank "
                   "(default 0 = as soon as it heartbeats)")
    p.add_argument("--chaos-kill-signal", action="append", default=None,
                   choices=("KILL", "TERM"), metavar="SIG",
                   help="signal for the matching --chaos-kill-rank: KILL "
                   "= hard crash (no emergency checkpoint), TERM = "
                   "preemption notice (cooperative checkpoint first)")
    args = p.parse_args(argv)
    if not command:
        p.error("worker command missing: python -m "
                "distributed_neural_network_tpu_torch.launch [flags] -- python -m "
                "distributed_neural_network_tpu_torch.lm_train ...")

    from .parallel.fault import KillEvent, ProcessChaos
    from .train.supervisor import FleetFederation, Supervisor, SupervisorConfig
    from .utils.obs import MetricsRegistry, ObsServer

    chaos = None
    if args.chaos_kill_rank:
        ranks = args.chaos_kill_rank
        steps = args.chaos_kill_at_step or []
        sigs = args.chaos_kill_signal or []
        events = tuple(
            KillEvent(
                rank=r,
                at_step=steps[i] if i < len(steps) else 0,
                sig=sigs[i] if i < len(sigs) else "KILL",
            )
            for i, r in enumerate(ranks)
        )
        chaos = ProcessChaos(events=events)
    elif args.chaos_kill_at_step or args.chaos_kill_signal:
        p.error("--chaos-kill-at-step/--chaos-kill-signal configure "
                "--chaos-kill-rank, which was not given")

    if args.devices_per_proc != 1:
        p.error(f"--devices-per-proc {args.devices_per_proc}: a torch worker drives one "
                "device (its card is picked from LOCAL_RANK); run one worker a card with "
                "--nprocs instead")
    cfg = SupervisorConfig(
        nprocs=args.nprocs,
        devices_per_proc=args.devices_per_proc,
        force_host_devices=not args.no_force_host_devices,
        min_procs=args.min_procs,
        max_restarts=args.max_restarts,
        restart_backoff_s=args.restart_backoff,
        rendezvous_retries=args.rendezvous_retries,
        rendezvous_timeout_s=args.rendezvous_timeout,
        grace_s=args.grace,
        failure_settle_s=args.failure_settle,
        heartbeat_timeout_s=args.heartbeat_timeout,
        grow_after_s=args.grow_after,
        poll_s=args.poll,
    )
    registry = MetricsRegistry()
    server = None
    if args.metrics_port is not None:
        server = ObsServer(registry, port=args.metrics_port)
        registry.mark_ready()
        print(f"(supervisor metrics: {server.url}/metrics)")
    sup = Supervisor(
        command,
        cfg,
        run_dir=args.run_dir or os.path.join(os.getcwd(), "supervisor_run"),
        chaos=chaos,
        registry=registry,
        federation=FleetFederation(
            registry,
            scrape_interval_s=args.scrape_interval,
            attrib_min_skew_s=args.straggler_min_skew,
        ),
    )
    try:
        return sup.run()
    finally:
        if server is not None:
            server.close()


if __name__ == "__main__":
    sys.exit(main())
