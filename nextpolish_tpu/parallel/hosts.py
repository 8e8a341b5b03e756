"""Multi-host work partitioning and launch glue.

Partitioning (blc_genome role, source/nextPolish:93-117): the reference bins
contigs into `parallel_jobs` blocks by cumulative length and submits one
shell job per block.  Here the same greedy binning assigns contig blocks to
JAX processes: each host polishes its block and writes its own part file;
the rank-0 host gathers (shared filesystem, like the reference's `cat`).

Launch (Paralleltask multi-node role, doc/OPTION.rst:75-113): instead of a
cluster scheduler + done-flag files, every host runs the same
`python -m nextpolish_tpu run.cfg` with three env vars and coordination
runs over jax.distributed:

    NPT_COORDINATOR=host0:9876  NPT_NUM_PROCS=4  NPT_PROC_ID=<rank>

Stage boundaries are device-level barriers (sync_global_devices), replacing
the reference's filesystem polling of per-job done markers.
"""
from __future__ import annotations

import os

_INITIALIZED = False


def _slurm_first_node(nodelist: str) -> str:
    """First hostname of a SLURM nodelist ('a,b', 'node[003-004]', ...)."""
    head = nodelist.split(",")[0]
    if "[" in head:
        base, rng = head.split("[", 1)
        first = rng.rstrip("]").split(",")[0].split("-")[0]
        return base + first
    return head


def init_distributed() -> int:
    """Initialize jax.distributed from NPT_* env vars (no-op without
    them).  Under SLURM (npt-launch --slurm), rank/count/coordinator fall
    back to SLURM_PROCID / SLURM_NTASKS / the first allocation node.
    Returns the process count."""
    global _INITIALIZED
    import jax

    env = os.environ
    coord = env.get("NPT_COORDINATOR")
    nprocs = env.get("NPT_NUM_PROCS") or env.get("SLURM_NTASKS")
    rank = env.get("NPT_PROC_ID") or env.get("SLURM_PROCID")
    if coord is None and env.get("SLURM_JOB_NODELIST") and nprocs:
        coord = _slurm_first_node(env["SLURM_JOB_NODELIST"]) + ":9876"
    if coord and int(nprocs or 1) > 1 and not _INITIALIZED:
        if env.get("JAX_PLATFORMS", "").startswith("cpu"):
            # CPU multi-process needs a cross-process collectives impl
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nprocs),
            process_id=int(rank),
        )
        _INITIALIZED = True
    return jax.process_count()


def barrier(name: str) -> None:
    """Block until every process reaches this point (the analog of the
    reference waiting for all Paralleltask jobs of a stage)."""
    import jax

    if jax.process_count() <= 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def blc_genome(lengths: dict, n_blocks: int) -> dict:
    """contig name -> block id, greedy by cumulative length
    (source/nextPolish:106-114 semantics)."""
    total = sum(lengths.values())
    blocksize = int(total / float(n_blocks) + 1)
    out = {}
    acc = 0
    block = 0
    for name, ln in lengths.items():
        out[name] = block
        acc += ln
        if acc >= blocksize:
            acc = 0
            block += 1
    return out


def my_contigs(lengths: dict) -> list:
    """Contigs assigned to this process under jax.distributed.

    Single-process runs get everything; multi-host runs split by
    blc_genome over jax.process_count()."""
    import jax

    n = jax.process_count()
    if n <= 1:
        return list(lengths)
    blocks = blc_genome(lengths, n)
    me = jax.process_index()
    return [name for name, b in blocks.items() if b == me]
