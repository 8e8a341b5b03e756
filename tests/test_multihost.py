"""Multi-host launch glue: 2 real OS processes coordinated by
jax.distributed run the pipeline end-to-end, each polishing its contig
block (blc_genome role) and rank 0 gathering — then the result must be
byte-identical to a single-process run.

This is the JAX analog of the reference's Paralleltask multi-node
path (doc/OPTION.rst:75-113): same command on every host + NPT_* env vars
instead of a cluster scheduler, device barriers instead of done-marker
polling.
"""
import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from util_sim import make_draft, rand_seq

_COMP = bytes.maketrans(b"ACGT", b"TGCA")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_project(tmp_path, rng, n_ctg=3, L=5000, depth=40):
    trues = []
    drafts = []
    for c in range(n_ctg):
        true = rand_seq(rng, L + 977 * c)
        draft, _ = make_draft(rng, true, n_edits=8)
        trues.append(true)
        drafts.append(draft)
    with open(tmp_path / "draft.fa", "wb") as fh:
        for c, d in enumerate(drafts):
            fh.write(b">ctg%d x\n" % c + d + b"\n")
    r1, r2 = [], []
    for c, true in enumerate(trues):
        n_pairs = depth * len(true) // 300
        for i in range(n_pairs):
            p = int(rng.integers(0, len(true) - 400))
            r1.append((f"c{c}p{i}", true[p : p + 150]))
            r2.append((f"c{c}p{i}",
                       true[p + 250 : p + 400].translate(_COMP)[::-1]))
    for fn, reads in (("r1.fq.gz", r1), ("r2.fq.gz", r2)):
        with gzip.open(tmp_path / fn, "wt") as fh:
            for name, seq in reads:
                fh.write(f"@{name}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
    (tmp_path / "sgs.fofn").write_text("r1.fq.gz\nr2.fq.gz\n")


def _write_cfg(tmp_path, workdir):
    p = tmp_path / f"{workdir}.cfg"
    p.write_text(
        f"""
task = 1
genome = ./draft.fa
sgs_fofn = ./sgs.fofn
workdir = ./{workdir}
parallel_jobs = 2
multithread_jobs = 2
"""
    )
    return str(p)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env(rank, nproc, port):
    env = dict(os.environ)
    env.pop("JAX_ENABLE_X64", None)
    env["PYTHONPATH"] = _REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["NPT_COORDINATOR"] = f"127.0.0.1:{port}"
    env["NPT_NUM_PROCS"] = str(nproc)
    env["NPT_PROC_ID"] = str(rank)
    return env


@pytest.mark.slow
def test_two_process_pipeline_matches_single(tmp_path):
    rng = np.random.default_rng(33)
    _make_project(tmp_path, rng)

    # single-process reference run (same child environment minus NPT_*)
    cfg1 = _write_cfg(tmp_path, "work1")
    env1 = _child_env(0, 1, 1)
    for k in ("NPT_COORDINATOR", "NPT_NUM_PROCS", "NPT_PROC_ID"):
        env1.pop(k)
    r = subprocess.run([sys.executable, "-m", "nextpolish_tpu", cfg1],
                       cwd=tmp_path, env=env1, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]

    # 2-process run
    cfg2 = _write_cfg(tmp_path, "work2")
    port = _free_port()
    procs = [
        subprocess.Popen([sys.executable, "-m", "nextpolish_tpu", cfg2],
                         cwd=tmp_path, env=_child_env(rank, 2, port),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for rank in range(2)
    ]
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]

    one = (tmp_path / "work1" / "genome.nextpolish.fasta").read_bytes()
    two = (tmp_path / "work2" / "genome.nextpolish.fasta").read_bytes()
    assert one == two
    # both ranks actually polished something
    part = tmp_path / "work2" / "01.score_chain" / "genome.nextpolish.part.fasta"
    for rank in range(2):
        rp = str(part) + f".rank{rank}"
        assert os.path.exists(rp) and os.path.getsize(rp) > 0
