"""python -m paddle_tpu_torch.distributed.launch: the distributed launcher,
the counterpart of ``paddle_tpu/distributed/launch/main.py`` (upstream
``launch/main.py:23``, ``controllers/collective.py:22``
``CollectiveController.build_pod``).

It resolves the node list, exports each worker's environment
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_RESTART_COUNT``, and ``MASTER_ADDR``/``MASTER_PORT`` from the
first endpoint unless the caller set them), starts and watches the
workers, and restarts or propagates failures (``--elastic_mode``
``collapse``, ``shrink``, ``grow``; hot spares marked
``PADDLE_ELASTIC_SPARE=1``); each worker's output goes to
``<log_dir>/workerlog.<node>.<local>.e<epoch>``. Several nodes meet
through the master (``master.py``) over the port's ``TCPStore``.

The port runs one process a card: ``--nproc_per_node`` workers, whose
``init_parallel_env()`` reads that environment, and worker r takes card
r mod the card count (``parallel_env.init_parallel_env``), its local
rank when each node runs as many workers as it has cards. One worker
with no restart asked for runs in the launcher's process, as the
reference's does; with ``--max_restarts`` it runs as a child, so that a
failure can be restarted.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch a distributed training job")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=int(
        os.environ.get("PADDLE_NODE_RANK", 0)))
    p.add_argument("--master", type=str,
                   default=os.environ.get("PADDLE_MASTER", ""),
                   help="host:port of rank-0 rendezvous")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--ips", type=str, default="",
                   help="comma-separated host list (informational)")
    p.add_argument("--devices", type=str, default="",
                   help="accepted for reference-CLI compat; worker r "
                        "takes card r mod the card count")
    from ..._core.flags import flag_value
    p.add_argument("--log_dir", type=str,
                   default=flag_value("FLAGS_launch_log_dir"))
    p.add_argument("--job_id", type=str, default="default")
    p.add_argument("--max_restarts", type=int, default=int(
        os.environ.get("PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL",
                       flag_value("FLAGS_launch_max_restarts"))) or 0,
        help="relaunch the pod up to N times on worker failure "
             "(elastic manager restart behavior)")
    p.add_argument("--elastic_mode",
                   choices=("collapse", "shrink", "grow"),
                   default="collapse",
                   help="worker-failure policy: 'collapse' (default) "
                        "tears the pod down and restarts/propagates; "
                        "'shrink' tolerates dead workers while at "
                        "least --min_np survive — the survivors keep "
                        "running (and re-plan via their own "
                        "ElasticManager/AdaptiveTrainer membership "
                        "epochs) instead of being restarted; 'grow' "
                        "is shrink plus HOT SPARES: up to --max_np "
                        "workers are spawned, the extras marked "
                        "PADDLE_ELASTIC_SPARE=1 — they warm their compile "
                        "caches outside the mesh and are admitted by "
                        "the ElasticManager master when a preemption "
                        "or grow event makes room")
    p.add_argument("--min_np", type=int, default=0,
                   help="shrink/grow mode: minimum live workers per "
                        "node; 0 = all must survive (tolerates "
                        "nothing)")
    p.add_argument("--max_np", type=int, default=0,
                   help="grow mode: total workers to spawn per node "
                        "(hot spares = max_np - nproc_per_node); 0 or "
                        "<= nproc_per_node = no spares")
    p.add_argument("script", type=str)
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _worker_env(args, node_rank: int, local_rank: int, world: int,
                endpoints, epoch: int):
    env = dict(os.environ)
    rank = node_rank * args.nproc_per_node + local_rank
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_CURRENT_ENDPOINT": endpoints[rank] if rank < len(endpoints)
        else "",
        "PADDLE_JOB_ID": args.job_id,
        "PADDLE_RESTART_COUNT": str(epoch),
    })
    # workers rendezvous on the first trainer endpoint (distinct from the
    # launcher's own master store) unless the caller pinned one
    if "MASTER_ADDR" not in os.environ and endpoints:
        env["MASTER_ADDR"] = endpoints[0].rsplit(":", 1)[0]
        env["MASTER_PORT"] = endpoints[0].rsplit(":", 1)[1]
    return env


def _nspawn(args) -> int:
    """Workers spawned per node: nproc_per_node, plus hot spares up to
    --max_np in grow mode."""
    if args.elastic_mode == "grow" and args.max_np > args.nproc_per_node:
        return args.max_np
    return args.nproc_per_node


def _spawn_pod(args, node_rank: int, world: int, endpoints, epoch: int):
    os.makedirs(args.log_dir, exist_ok=True)
    procs = []
    for lr in range(_nspawn(args)):
        env = _worker_env(args, node_rank, lr, world, endpoints, epoch)
        if lr >= args.nproc_per_node:
            # hot spare: outside the initial mesh — the worker script
            # gates on this env (warm caches, announce to the elastic
            # master, wait for admission) instead of joining rank 0's
            # initial rendezvous
            env["PADDLE_ELASTIC_SPARE"] = "1"
        log = open(os.path.join(
            args.log_dir,
            f"workerlog.{node_rank}.{lr}.e{epoch}"), "w")
        procs.append((lr, subprocess.Popen(
            [sys.executable, args.script] + args.script_args, env=env,
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _kill_pod(procs):
    for _, proc, _ in procs:
        if proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
    deadline = time.time() + 10
    for _, proc, _ in procs:
        try:
            proc.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            proc.kill()
    for _, _, log in procs:
        log.close()


def _watch_pod(procs, master=None, epoch: int = 0, args=None):
    """Poll until the pod finishes. Returns (rc, failed): first non-zero
    exit fails the pod; with a master, a REMOTE node's failure signal
    also tears this pod down (controllers/controller.py:87 watch +
    elastic fault broadcast).

    Shrink mode (`--elastic_mode shrink`): a dead worker does NOT tear
    the pod down while at least --min_np workers stay live — the
    launcher records the loss and keeps watching, and the surviving
    trainers (who see the death through their own ElasticManager
    heartbeats) re-plan and keep training. Only dropping below min_np
    fails the pod. Grow mode watches the same way (spares that exit
    cleanly after admission-and-finish don't fail the pod either)."""
    shrink = args is not None and args.elastic_mode in ("shrink", "grow")
    nproc = len(procs)
    min_np = (args.min_np or args.nproc_per_node) if shrink else 0
    lost = []
    last_remote_check = 0.0
    while procs:
        alive = []
        for rank, proc, log in procs:
            r = proc.poll()
            if r is None:
                alive.append((rank, proc, log))
            elif r != 0:
                if shrink:
                    lost.append(rank)
                    log.close()
                    survivors = nproc - len(lost)
                    print(f"[launch] worker {rank} died (rc={r}); "
                          f"shrink mode keeps the pod with "
                          f"{survivors} survivor(s)", file=sys.stderr)
                    if survivors >= min_np:
                        continue
                    print(f"[launch] survivors {survivors} < min_np "
                          f"{min_np}: pod fails", file=sys.stderr)
                return r, True
            else:
                log.close()  # finished worker: release the handle now
        procs[:] = alive
        now = time.time()
        if master is not None and now - last_remote_check > 2.0:
            last_remote_check = now
            if master.poll_failure(epoch):
                return 1, True
        time.sleep(0.3)
    if lost:
        print(f"[launch] pod finished after shrinking past dead "
              f"worker(s) {lost}", file=sys.stderr)
    return 0, False


def _node_host(master_host: str) -> str:
    """This node's advertised address (NOT the master's — a remote
    machine registering the master host would rendezvous against the
    wrong box)."""
    ip = os.environ.get("PADDLE_LOCAL_IP") or os.environ.get("POD_IP")
    if ip:
        return ip
    if master_host in ("127.0.0.1", "localhost"):
        return "127.0.0.1"  # single-machine (simulated multi-node)
    import socket as _socket
    try:
        # UDP connect picks the outbound interface without sending
        s = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        s.connect((master_host, 1))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return _socket.gethostbyname(_socket.gethostname())


def main(argv=None):
    args = _parse_args(argv)
    world = args.nnodes * args.nproc_per_node
    nsp = _nspawn(args)   # per-node spawn count incl. hot spares
    master_ep = args.master or "127.0.0.1:6170"
    host, port = (master_ep.split(":") + ["6170"])[:2]

    if world == 1 and nsp == 1 and args.max_restarts == 0:
        # single process, nothing to restart: exec in-place (fast path,
        # no fork)
        endpoints = [f"{host}:{port}"]
        os.environ.update(_worker_env(args, 0, 0, 1, endpoints, 0))
        sys.argv = [args.script] + args.script_args
        import runpy
        runpy.run_path(args.script, run_name="__main__")
        return 0

    # multi-node rendezvous through the store master; single-node jobs
    # skip it and use static port arithmetic
    master = None
    if args.nnodes > 1:
        from .master import Master
        master = Master(f"{host}:{port}", args.job_id,
                        is_master=(args.node_rank == 0),
                        world_nodes=args.nnodes)

    epoch = 0
    while True:
        if master is not None:
            # re-registration order fixes node ranks for THIS epoch:
            # rerank-on-restart for free; each node advertises its OWN
            # address
            my_ep = (f"{_node_host(host)}:"
                     f"{int(port) + 1 + args.node_rank * nsp}")
            node_rank = master.register_node(epoch, my_ep, nsp)
            peers = master.wait_peers(epoch)
            if any(np_ != nsp for _, np_ in peers):
                # rank/world arithmetic assumes a homogeneous pod; fence
                # the exit so a peer mid-rendezvous doesn't hit a dead
                # store
                print("[launch] nproc_per_node differs across nodes: "
                      f"{[np_ for _, np_ in peers]}", file=sys.stderr)
                master.signal_failure(epoch)
                master.ack_exit(is_owner=(args.node_rank == 0))
                return 1
            from .master import global_endpoints
            endpoints = global_endpoints(peers)
        else:
            node_rank = args.node_rank
            # endpoints cover the FULL spawn set (spares included in
            # grow mode) so an admitted spare has a real address
            endpoints = [
                f"{host}:{int(port) + n * nsp + p_}"
                for n in range(args.nnodes)
                for p_ in range(nsp)]

        procs = _spawn_pod(args, node_rank, world, endpoints, epoch)
        try:
            rc, failed = _watch_pod(procs, master, epoch, args=args)
        except KeyboardInterrupt:
            _kill_pod(procs)  # Ctrl-C must not orphan the workers
            if master is not None:
                master.signal_failure(epoch)
                # peers take the restart path and may never ack: bound
                # the owner's grace period instead of the 60s default
                master.ack_exit(is_owner=(args.node_rank == 0),
                                timeout=5.0)
            return 130
        _kill_pod(procs)
        if not failed:
            if master is None:
                return 0
            # a clean node must stay in the coordination protocol: if a
            # peer fails this epoch, everyone restarts together —
            # otherwise the survivors would wait 300s for a node that
            # already returned
            master.signal_done(epoch)
            deadline = time.time() + 600
            while True:
                if master.poll_done(epoch) >= args.nnodes:
                    master.ack_exit(is_owner=(args.node_rank == 0))
                    return 0
                if master.poll_failure(epoch):
                    failed, rc = True, 1
                    break
                if time.time() > deadline:
                    print("[launch] timed out waiting for peer nodes "
                          "to finish", file=sys.stderr)
                    return 1
                time.sleep(0.5)
        if master is not None:
            master.signal_failure(epoch)
        if epoch >= args.max_restarts:
            if master is not None:
                # terminal-failure fence (mirror of the clean-exit ack):
                # the store owner must outlive every peer's next failure
                # poll, or survivors never learn the job is dead
                master.ack_exit(is_owner=(args.node_rank == 0))
            return rc or 1
        epoch += 1
        print(f"[launch] pod failed (rc={rc}); restart "
              f"{epoch}/{args.max_restarts}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
