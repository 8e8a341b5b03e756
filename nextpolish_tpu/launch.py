"""npt-launch: spawn/submit the per-host processes of a multi-host run.

The reference submits its jobs through Paralleltask to a local shell or
an SGE/PBS/SLURM cluster (source/nextPolish:396-521, doc/OPTION.rst:75-113).
The JAX equivalent is one `python -m nextpolish_tpu run.cfg` process per
host (or per local GPU) coordinated over jax.distributed
(parallel/hosts.py); this launcher is the piece that *starts* those
processes:

    # local N-process run, one process per local GPU:
    python -m nextpolish_tpu.launch --nprocs 2 run.cfg

    # ssh to a host list (first host is the coordinator):
    python -m nextpolish_tpu.launch --hosts node-a,node-b run.cfg

    # inside a SLURM allocation (uses srun; ranks come from SLURM_PROCID):
    python -m nextpolish_tpu.launch --slurm --nprocs 2 run.cfg

Every spawned process receives NPT_COORDINATOR / NPT_NUM_PROCS /
NPT_PROC_ID (the protocol parallel/hosts.init_distributed consumes);
under --slurm the rank env is filled from SLURM_PROCID at task startup.
See docs/MULTIHOST.md for the 2-host scaling runbook.
"""
from __future__ import annotations

import argparse
import os
import shlex
import socket
import subprocess
import sys


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_cmd(cfg: str) -> list[str]:
    return [sys.executable, "-m", "nextpolish_tpu", cfg]


def local_rank_env(rank: int, nprocs: int, base_env: dict) -> dict:
    """Environment of local rank `rank`: it sees exactly one GPU, the
    rank-th of CUDA_VISIBLE_DEVICES (default: card `rank`), because a JAX
    process reserves most of every card it can see."""
    visible = base_env.get("CUDA_VISIBLE_DEVICES")
    ids = visible.split(",") if visible else [str(i) for i in range(nprocs)]
    if nprocs > len(ids):
        raise ValueError(f"{nprocs} processes but only {len(ids)} visible "
                         f"devices (CUDA_VISIBLE_DEVICES={visible})")
    return {"CUDA_VISIBLE_DEVICES": ids[rank]}


def launch_local(cfg: str, nprocs: int, base_env: dict) -> int:
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for rank in range(nprocs):
        env = dict(base_env, NPT_COORDINATOR=coord,
                   NPT_NUM_PROCS=str(nprocs), NPT_PROC_ID=str(rank),
                   **local_rank_env(rank, nprocs, base_env))
        procs.append(subprocess.Popen(_worker_cmd(cfg), env=env))
    # wait on EVERY process (no short-circuit): all ranks must be reaped
    # even after an early failure, and the first nonzero code wins
    codes = [p.wait() for p in procs]
    return next((c for c in codes if c), 0)


def launch_ssh(cfg: str, hosts: list[str], port: int, base_env: dict) -> int:
    coord = f"{hosts[0]}:{port}"
    procs = []
    for rank, host in enumerate(hosts):
        envs = " ".join(
            f"{k}={shlex.quote(v)}"
            for k, v in (("NPT_COORDINATOR", coord),
                         ("NPT_NUM_PROCS", str(len(hosts))),
                         ("NPT_PROC_ID", str(rank))))
        cmd = f"cd {shlex.quote(os.getcwd())} && {envs} " + " ".join(
            shlex.quote(c) for c in _worker_cmd(cfg))
        procs.append(subprocess.Popen(["ssh", host, cmd]))
    codes = [p.wait() for p in procs]
    return next((c for c in codes if c), 0)


def launch_slurm(cfg: str, nprocs: int, base_env: dict) -> int:
    """srun inside an existing allocation: rank/count/coordinator resolve
    from SLURM_* at task startup (hosts.init_distributed fallbacks)."""
    env = dict(base_env)
    env.setdefault("NPT_NUM_PROCS", str(nprocs))
    cmd = ["srun", "--ntasks", str(nprocs), "--ntasks-per-node", "1",
           *_worker_cmd(cfg)]
    return subprocess.call(cmd, env=env)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="npt-launch",
        description="Launch a multi-host nextpolish_tpu run "
                    "(Paralleltask submit role, doc/OPTION.rst:75-113).")
    ap.add_argument("config", help="run.cfg")
    ap.add_argument("--nprocs", type=int, default=0,
                    help="process count (local/slurm modes)")
    ap.add_argument("--hosts", default="",
                    help="comma-separated ssh host list (rank order; "
                         "first host runs the coordinator)")
    ap.add_argument("--slurm", action="store_true",
                    help="submit via srun inside a SLURM allocation")
    ap.add_argument("--port", type=int, default=9876,
                    help="coordinator port (ssh mode)")
    args = ap.parse_args(argv)
    base_env = dict(os.environ)
    if args.slurm:
        n = args.nprocs or int(os.environ.get("SLURM_NTASKS", "0"))
        if not n:
            ap.error("--slurm needs --nprocs or SLURM_NTASKS")
        return launch_slurm(args.config, n, base_env)
    if args.hosts:
        hosts = [h for h in args.hosts.split(",") if h]
        return launch_ssh(args.config, hosts, args.port, base_env)
    if args.nprocs > 1:
        return launch_local(args.config, args.nprocs, base_env)
    ap.error("pick one of --nprocs N, --hosts a,b or --slurm")


if __name__ == "__main__":
    raise SystemExit(main())
