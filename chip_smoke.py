#!/usr/bin/env python3
"""Smoke check: the polishing pipeline on NVIDIA GPUs, end to end.

    python chip_smoke.py              # one card: phases 1-3
    python chip_smoke.py --devices 4  # four cards: the multi-card path only

One card:
  1. setup    build libnpt.so from the tracked sources for this host's
              CPU (make -B: the Makefile builds with -march=native).
  2. kernels  every device kernel of the main path at production widths,
              compared with its plain reference by exact equality (all
              outputs are integers, bytes or CIGARs; both sides compute
              in int32/float32, no reduced-precision matmuls):
              - task-1 chain DP (ops/tropical.py), one 100 kb contig at
                40x, GPU against the same jitted function on the CPU
                backend; and the windowed route (2^17-cell windows) on a
                1.2 Mb contig against one whole-contig launch (phase 3's
                stage-2 check puts it against the CPU backend);
              - engine-2 level scan: B = 8 windows (4 x 12 kb, 4 x 50 kb,
                30x) for all four read types, the Triton kernel against
                the plain lax.scan on the GPU and the consensus against
                the native C++ cns_dp, in both (E, Vb) buckets;
              - banded alignment (align/extend.py), every bucket shape a
                sample of simulated ONT and PE150 reads uses, GPU
                against CPU;
              then the test suite's `gpu`-marked tests on this card.
  3. e2e      a simulated 2 Mb bacterial draft (3 contigs: 1.2, 0.5,
              0.3 Mb) with PE150 reads at 30x and ONT-like reads at 15x
              (~5 kb, ~5% error), polished by `python -m nextpolish_tpu
              run.cfg` (task = default: 5, 1, 2) with the device
              consensus engine forced.  The CLI runs twice on one workdir:
              first with task = 51, then with task = default, which skips
              the two finished stages and runs the third (the pipeline's
              resume).  In between, the smoke moves the spilled alignments
              of stages 1 and 2 aside, because stage 3 maps to the same
              spill directory.  Checks: complete output; residual errors
              against the truth at most 1/ACCURACY_FACTOR of the draft's;
              stage 1 byte-equal to worker2 on the native engine and
              stage 2 byte-equal to worker1 on the CPU backend, each on the
              stage's own alignments; then calib picks an engine.
Four cards (--devices 4): the task-5 and task-1 pipeline engines with
all four cards (window groups and contigs round-robin over them; every
card must get a launch of each), and the reads-psum router over NCCL on
the 1.2 Mb contig, each byte-equal to the same call on the first card
alone.  The draft adds 30 contigs of 20 kb to phase 3's three
(MULTI_CONTIGS, a fragmented draft): task 5 windows are >= 4 Mb, so one
per contig, and 33 windows fill at least ceil(33 / B_MAX) = 5 groups,
more than there are cards; task 1 gets 32 contigs under the windowed
route's 1 Mb.  Read depth is cut to MULTI_DEPTH.

Each phase runs in a child process, one after another; the parent never
imports JAX, so one process holds the cards at a time.  A failed phase
fails the script (exit code != 0, no result line).  Lines tagged with the
card's name and power limit report wall and compile times,
compiled.memory_analysis() and peak_bytes_in_use.  The last line of
standard output is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")  # logs
WORK = os.path.join(ROOT, ".smoke_work")  # simulated inputs and run dirs
SEED = 0
# the polished output's mismatches + indel bases against the truth must
# be at most 1/ACCURACY_FACTOR of the draft's
ACCURACY_FACTOR = 10
# genome shape of the e2e and multi-card runs (never cut) and read depth
# (the one dimension a time limit may cut)
CONTIGS = (1_200_000, 500_000, 300_000)
SGS_DEPTH = 30
ONT_DEPTH = 15
ONT_MEAN_LEN = 5000
ONT_ERR = (0.02, 0.015, 0.015)  # substitution, insertion, deletion
DRAFT_ERR = (0.003, 0.003)  # substitution, indel
MULTI_CONTIGS = CONTIGS + (20_000,) * 30
MULTI_DEPTH = dict(sgs_depth=10, ont_depth=8)
GPU_ENV = {"JAX_PLATFORMS": "cuda,cpu"}
CPU_ENV = {"JAX_PLATFORMS": "cpu"}


def card_line() -> str:
    return os.environ.get("NPT_SMOKE_CARD", "?")


def report(kind: str, **fields) -> None:
    """One measurement line, tagged with the card it was taken on."""
    print(f"[{card_line()}] {kind}: {json.dumps(fields, default=str)}",
          flush=True)


# ---------------------------------------------------------------------------
# child-process helpers (JAX lives only here)
# ---------------------------------------------------------------------------

def init_jax():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: jax.devices()[0] is {dev.platform}")
    return jax


def device_info(jax) -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def mem_fields(compiled) -> dict:
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def run_compiled(jax, name, jitted, args, static, device, reps=3,
                 show=True):
    """Compile `jitted` for `device`, run it `reps` times (each ending in
    block_until_ready); returns the host copy of the output."""
    args = jax.device_put(args, device)
    t0 = time.perf_counter()
    comp = jitted.lower(*args, **static).compile()
    t_compile = time.perf_counter() - t0
    times = []
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(comp(*args))
        times.append(time.perf_counter() - t0)
    if show:
        report(f"kernel {name}", device=str(device), compile_s=t_compile,
               run_s=times, memory=mem_fields(comp))
    return jax.device_get(out)


def peak_bytes(jax) -> int | None:
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# phase 2: kernel parity at production widths
# ---------------------------------------------------------------------------

def chain_parity(jax, gpu, cpu, L=100_000, big=1_200_000):
    from bench import make_task1_case
    from nextpolish_tpu.models.score_chain import (
        AlgoConfig,
        score_chain_contig,
        score_chain_contig_prep,
        score_chain_contig_sharded,
    )
    from nextpolish_tpu.ops.tropical import chain_correct_planes_batch
    from jax.sharding import Mesh

    cfg = AlgoConfig()
    rng = np.random.default_rng(SEED)
    names, trues, batch, _ = make_task1_case(rng, L=L, depth=40,
                                             n_contigs=1)
    # rate 0.5 (short reads) makes total*rate exact in float32; 1/3 (the
    # long-read factor) does not, so it would expose a fused multiply-add
    # the CPU backend does not also form
    for rate in (cfg.indel_balance_factor_sgs, cfg.indel_balance_factor_lgs):
        h = score_chain_contig_prep(
            names[0], trues[0], batch,
            AlgoConfig(indel_balance_factor_sgs=rate))
        assert h.key[0] == "planes", h.key
        static = dict(zip(("L", "Emax", "EOV", "ET", "FMT", "TH", "PS"),
                          h.key[1:]))
        outs = [run_compiled(jax, f"task1_chain rate={rate}",
                             chain_correct_planes_batch, (h.buf[None],),
                             static, d) for d in (gpu, cpu)]
        assert same(*outs), f"task-1 chain (rate {rate}): GPU != CPU"
        report("parity task1_chain", cells=int(static["L"]), rate=rate,
               equal=True)

    # the windowed route (contigs > 1 Mb) against one whole-contig launch
    # on the GPU; phase 3's stage-2 check compares it with the CPU backend
    names, trues, batch, _ = make_task1_case(rng, L=big, depth=40,
                                             n_contigs=1)
    mesh = Mesh(np.array([gpu]), ("reads",))
    t0 = time.perf_counter()
    windowed = score_chain_contig_sharded(names[0], trues[0], batch, cfg,
                                          mesh, window_cells=1 << 17)
    t1 = time.perf_counter()
    whole = score_chain_contig(names[0], trues[0], batch, cfg)
    report("run task1_windowed", bases=big, windowed_s=t1 - t0,
           whole_contig_s=time.perf_counter() - t1)
    assert windowed == whole, "task-1 windowed route != one launch"
    report("parity task1_windowed", bases=big, equal=True)


def level_scan_parity(jax, gpu, lengths=(12_000, 50_000)):
    from nextpolish_tpu import native
    from nextpolish_tpu.models.cns import device_dp as dd
    from nextpolish_tpu.models.cns.calib import _probe_window
    from nextpolish_tpu.models.cns.dp import COV_COEF, traceback

    assert native.available(), "libnpt.so did not load"
    wins = ([_probe_window("ont", lengths[0], seed=s) for s in range(4)]
            + [_probe_window("ont", lengths[1], seed=10 + s)
               for s in range(4)])
    preps = [dd.prepare_window(*w) for w in wins]
    dws = [dw for _, dw in preps]
    assert all(dw is not None for dw in dws)
    bases = sum(w[2] for w in wins)
    report("level_scan windows", n=len(dws), bases=bases,
           levels=[dw.n_levels for dw in dws], E=[dw.E for dw in dws],
           Vb=[dw.Vb for dw in dws])
    timing = {}
    for rt in ("ont", "clr", "rs", "hifi"):
        rt_id, c = dd.READ_TYPE_ID[rt], COV_COEF[rt]
        lq = 80 if rt == "hifi" else 20
        first = None
        for bucket in ((0, 0), (dd.E_BUCKETS[-1], dd.VB_BUCKETS[-1])):
            pk = dd.pack_group(dws, E=bucket[0], Vb=bucket[1])
            B, P = pk.lvl.shape
            kern = dd.get_scan(True, pk.E, pk.Vb, rt_id, c, B, pk.NCL, P)
            best, sc = run_compiled(
                jax, f"level_scan_kernel {rt} E={pk.E} Vb={pk.Vb}", kern,
                pk.args(), {}, gpu)
            # levels past a window's end are not written: compare each
            # window's own levels
            got = [(best[i, :Lt], sc[i, :Lt]) for i, Lt in enumerate(pk.Lts)]
            if first is None:
                first = got
                plain = dd.get_scan(False, pk.E, pk.Vb, rt_id, c, B,
                                    pk.NCL, P)
                pb, ps = run_compiled(
                    jax, f"level_scan_plain {rt} E={pk.E} Vb={pk.Vb}",
                    plain, pk.args(), {}, gpu, reps=1)
                for i, Lt in enumerate(pk.Lts):
                    assert same(got[i], (pb[i, :Lt], ps[i, :Lt])), \
                        f"level scan {rt}: kernel != lax.scan (window {i})"
            else:
                assert same(got, first), \
                    f"level scan {rt}: bucket {bucket} differs"
        # consensus against the native engine
        t_native = 0.0
        for i, ((merged, cov, L), (edges, dw)) in enumerate(
                zip(wins, preps)):
            score, barr = dd._to_edge_outputs(dw, *first[i])
            mine = traceback(edges, score, barr, cov, L, rt, 4,
                             lq_min_qv=lq)
            t0 = time.perf_counter()
            nat = native.cns_dp(merged.t_pos, merged.delta, merged.q_base,
                                merged.row_off, cov, L, rt, 4, lq)
            t_native += time.perf_counter() - t0
            assert nat is not None
            assert same((mine.pos, mine.base, mine.qv), nat[:3]), \
                f"level scan {rt}: consensus != native (window {i})"
        # end to end for the batch: pack + transfer + scan + fetch
        ends = {}
        for kernel in (True, False):
            dd._run_batch(dws, rt, kernel=kernel)  # compile + warm
            t0 = time.perf_counter()
            dd._run_batch(dws, rt, kernel=kernel)
            ends["kernel" if kernel else "plain"] = \
                time.perf_counter() - t0
        timing[rt] = dict(end_to_end_s=ends, native_serial_s=t_native,
                          bases=bases)
        report(f"parity level_scan {rt}", equal=True, **timing[rt])
    return timing


def aligner_parity(jax, gpu, cpu, genome=200_000):
    from accuracy_bench import sim_genome, sim_long_reads, sim_pe_reads
    from nextpolish_tpu.align.index import GenomeIndex
    from nextpolish_tpu.align.longread import map_long_batch
    from nextpolish_tpu.align.mapper import map_short_batch

    rng = np.random.default_rng(SEED + 1)
    g = sim_genome(rng, genome)
    ont = sim_long_reads(rng, g, 3, ONT_MEAN_LEN, *ONT_ERR)[:150]
    r1, r2 = sim_pe_reads(rng, g, 2)
    pe = [x for pair in zip(r1[:2000], r2[:2000]) for x in pair]
    out = []
    for d in (gpu, cpu):
        with jax.default_device(d):
            t0 = time.perf_counter()
            lidx = GenomeIndex.build([("g", g)], k=15, w=10)
            lr = map_long_batch(lidx, ont)
            t1 = time.perf_counter()
            sidx = GenomeIndex.build([("g", g)], k=17, w=7)
            sr = map_short_batch(sidx, pe, paired=True)
            t2 = time.perf_counter()
        out.append((lr, sr))
        report("run aligner", device=str(d), ont_reads=len(ont),
               ont_s=t1 - t0, pe_reads=len(pe), pe_s=t2 - t1)

    def key(recs):
        return [None if r is None else
                (r["tid"], r["pos"], r["flag"], r["mapq"],
                 np.asarray(r["cigar"]).tolist()) for r in recs]
    for i, kind in enumerate(("ont", "pe150")):
        a, b = out[0][i], out[1][i]
        assert key(a) == key(b), f"band aligner ({kind}): GPU != CPU"
        report(f"parity aligner {kind}", records=len(a), equal=True)
    from nextpolish_tpu.align.extend import _band_align_ops

    q = np.full((16, 4096), 4, np.uint8)
    t = np.full((16, 4096 + 512), 4, np.uint8)
    run_compiled(jax, "band_align 4096x512 global", _band_align_ops,
                 (q, t, np.zeros(16, np.int32), np.ones(16, np.int32)),
                 dict(mode="global"), gpu, reps=1)


def phase_kernels():
    jax = init_jax()
    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    chain_parity(jax, gpu, cpu)
    timing = level_scan_parity(jax, gpu)
    aligner_parity(jax, gpu, cpu)
    report("phase kernels", wall_s=time.perf_counter() - t0,
           peak_bytes_in_use=peak_bytes(jax))
    return {"device": device_info(jax), "level_scan": timing}


def gpu_tests():
    """The test suite's GPU-only tests (marker `gpu`), on this card."""
    out = run_logged("gpu_tests", [sys.executable, "-m", "pytest", "tests/",
                                   "-q", "-m", "gpu", "-p",
                                   "no:cacheprovider", "-rs"],
                     GPU_ENV, cwd=ROOT, stream="stdout")
    m = re.search(r"(\d+) passed", out)
    assert m and int(m.group(1)) > 0 and "skipped" not in out \
        and "failed" not in out, f"GPU tests did not all run: {out[-2000:]}"
    report("gpu_tests", passed=int(m.group(1)))


# ---------------------------------------------------------------------------
# phase 3: end to end through the CLI
# ---------------------------------------------------------------------------

def simulate(wd, contigs=CONTIGS, sgs_depth=SGS_DEPTH, ont_depth=ONT_DEPTH):
    """Truth, draft and reads from SEED (tools/accuracy_bench.py
    simulators); returns paths."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from accuracy_bench import (
        mutate,
        sim_genome,
        sim_long_reads,
        sim_pe_reads,
        write_fasta,
        write_fastq_gz,
        write_reads_fa_gz,
    )

    os.makedirs(wd, exist_ok=True)
    rng = np.random.default_rng(SEED)
    truth, draft, r1, r2, ont = {}, {}, [], [], []
    for i, n in enumerate(contigs):
        name = f"ctg{i}"
        truth[name] = sim_genome(rng, n)
        draft[name] = mutate(rng, truth[name], *DRAFT_ERR)
        a, b = sim_pe_reads(rng, truth[name], sgs_depth)
        r1 += a
        r2 += b
        ont += sim_long_reads(rng, truth[name], ont_depth, ONT_MEAN_LEN,
                              *ONT_ERR)
    paths = {k: os.path.join(wd, v) for k, v in (
        ("truth", "truth.fa"), ("draft", "draft.fa"), ("r1", "r1.fq.gz"),
        ("r2", "r2.fq.gz"), ("ont", "ont.fa.gz"), ("work", "rundir"))}
    write_fasta(paths["truth"], truth)
    write_fasta(paths["draft"], draft)
    write_fastq_gz(paths["r1"], r1, "/1")
    write_fastq_gz(paths["r2"], r2, "/2")
    write_reads_fa_gz(paths["ont"], ont)
    for k, files in (("sgs", ("r1", "r2")), ("lgs", ("ont",))):
        paths[k] = os.path.join(wd, f"{k}.fofn")
        with open(paths[k], "w") as fh:
            fh.write("".join(paths[f] + "\n" for f in files))
    report("simulated", contigs=list(contigs), sgs_reads=2 * len(r1),
           sgs_depth=sgs_depth, ont_reads=len(ont), ont_depth=ont_depth)
    return paths


def write_cfg(paths, name, task, rewrite) -> str:
    """A run config over simulate()'s inputs; returns its path."""
    path = os.path.join(os.path.dirname(paths["draft"]), name)
    with open(path, "w") as fh:
        fh.write(f"""task = {task}
genome = {paths['draft']}
workdir = {paths['work']}
sgs_fofn = {paths['sgs']}
lgs_fofn = {paths['lgs']}
lgs_options = -min_read_len 1k -max_depth 100
lgs_minimap2_options = -x map-ont
sgs_options = -max_depth 100
rewrite = {rewrite}
""")
    return path


def read_fa(path) -> dict:
    """{name: sequence bytes} (the parent stays off the package)."""
    seqs, name = {}, None
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                name = line[1:].split()[0].decode()
                seqs[name] = []
            else:
                seqs[name].append(line.strip())
    return {k: b"".join(v) for k, v in seqs.items()}


def run_logged(tag, cmd, env_extra, cwd=None, stream="stderr"):
    """Run a command, echo its log tail on failure, return its stderr (or
    stdout)."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **env_extra)
    t0 = time.perf_counter()
    p = subprocess.run(cmd, env=env, cwd=cwd, capture_output=True,
                       text=True)
    wall = time.perf_counter() - t0
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"{tag}.log"), "w") as fh:
        fh.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
    if p.returncode:
        sys.stderr.write(p.stderr[-6000:])
        raise SystemExit(f"{tag} failed with exit code {p.returncode}")
    comp = [float(x) for x in re.findall(
        r"Finished XLA compilation of .* in ([0-9.]+) sec", p.stderr)]
    peak = re.findall(r"device peak_bytes_in_use: (\d+)", p.stderr)
    report(f"phase {tag}", wall_s=wall, compile_s=sum(comp),
           n_compiles=len(comp),
           peak_bytes_in_use=int(peak[-1]) if peak else None)
    return p.stdout if stream == "stdout" else p.stderr


def merge_parts(parts, out_bam):
    """samtools-merge role: one sorted, indexed BAM from spilled parts."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from nextpolish_tpu.io.bamregion import IndexedBam, merge_region_batches
    from ref_parity import batch_to_bam

    batches = [IndexedBam(p).fetch_all() for p in parts]
    batch_to_bam(merge_region_batches(batches, heap_rev=False), out_bam)


def stage_outputs(work):
    """[(stage_dir, part fasta)] in step order."""
    dirs = sorted(d for d in glob.glob(os.path.join(work, "[0-9][0-9].*"))
                  if os.path.isdir(d))
    return [(d, os.path.join(d, "genome.nextpolish.part.fasta"))
            for d in dirs]


def phase_e2e():
    wd = os.path.join(WORK, "e2e")
    t0 = time.perf_counter()
    paths = simulate(wd)
    report("phase simulate", wall_s=time.perf_counter() - t0)
    cli_env = dict(GPU_ENV, NPT_CNS_ENGINE="device", NPT_SPILL_BAM="1",
                   JAX_LOG_COMPILES="1")
    final = os.path.join(paths["work"], "genome.nextpolish.fasta")
    # stages 1 (task 5) and 2 (task 1), then keep their alignments: the
    # pipeline spills each read kind to one directory per run, and stage 3
    # (task 2) maps the short reads again
    run_logged("cli_stages_1_2",
               [sys.executable, "-m", "nextpolish_tpu",
                write_cfg(paths, "run.stages12.cfg", "51", "yes")], cli_env)
    spill = {k: os.path.join(wd, f"spill.{k}") for k in ("lgs", "sgs")}
    for k, d in spill.items():
        shutil.rmtree(d, ignore_errors=True)
        os.rename(os.path.join(paths["work"], f"spill.{k}"), d)
    for f in (final, final + ".stat"):
        os.remove(f)
    # the full run.cfg: stages 1 and 2 are finished, stage 3 runs
    log = run_logged("cli_resume_default",
                     [sys.executable, "-m", "nextpolish_tpu",
                      write_cfg(paths, "run.cfg", "default", "no")],
                     cli_env)
    assert log.count("Skip finished stage") == 2, "resume re-ran a stage"
    out = read_fa(final)
    draft = read_fa(paths["draft"])
    assert sorted(out) == sorted(draft), "output FASTA is incomplete"
    for n in draft:
        assert abs(len(out[n]) - len(draft[n])) < 0.01 * len(draft[n]), n

    stages = stage_outputs(paths["work"])
    assert len(stages) == 3, stages
    # stage 1 (task 5): worker2 on the native engine, same alignments
    (_, o1), (_, o2) = stages[0], stages[1]
    fofn = os.path.join(wd, "stage1.lgs.fofn")
    with open(fofn, "w") as fh:
        fh.write("".join(p + "\n" for p in sorted(
            glob.glob(os.path.join(spill["lgs"], "*.bam")))))
    host1 = os.path.join(wd, "stage1.native.fa")
    run_logged("worker2_native",
               [sys.executable, "-m", "nextpolish_tpu.worker2", "-g",
                paths["draft"], "-l", fofn, "-r", "ont", "-sp", "-o",
                host1], dict(CPU_ENV, NPT_CNS_ENGINE="native"))
    assert read_fa(host1) == read_fa(o1), \
        "stage 1 (ctg_cns): device engine != native engine"
    report("parity stage1_ctg_cns", equal=True)
    # stage 2 (task 1): worker1 on the CPU backend, same alignments
    parts = sorted(glob.glob(os.path.join(spill["sgs"], "*.bam")))
    bam = os.path.join(wd, "stage2.sgs.bam")
    run_logged("merge_bam", [sys.executable, "-c",
                             "import sys, chip_smoke; "
                             "chip_smoke.merge_parts(sys.argv[2:], "
                             "sys.argv[1])", bam, *parts], CPU_ENV,
               cwd=ROOT)
    host2 = os.path.join(wd, "stage2.cpu.fa")
    run_logged("worker1_cpu",
               [sys.executable, "-m", "nextpolish_tpu.worker1", "-g", o1,
                "-s", bam, "-t", "1", "-o", host2], CPU_ENV)
    assert read_fa(host2) == read_fa(o2), \
        "stage 2 (score_chain): GPU != CPU backend"
    report("parity stage2_score_chain", equal=True)
    return paths


def phase_accuracy(truth, draft, final):
    init_jax()
    from asm_stats import asm_stats

    res = {}
    for tag, fa in (("draft", draft), ("polished", final)):
        t0 = time.perf_counter()
        mm, ind, aln = asm_stats(fa, truth)
        res[tag] = {"mismatches": mm, "indel_bases": ind, "aligned": aln,
                    "per_100kb": 1e5 * (mm + ind) / max(aln, 1)}
        report(f"accuracy {tag}", wall_s=time.perf_counter() - t0,
               **res[tag])
    d, p = res["draft"], res["polished"]
    size = sum(len(v) for v in read_fa(truth).values())
    assert p["aligned"] > 0.95 * size, f"polished covers too little: {res}"
    assert p["per_100kb"] * ACCURACY_FACTOR <= d["per_100kb"], \
        f"polished errors not {ACCURACY_FACTOR}x below the draft's: {res}"
    return res


def phase_calib(path):
    jax = init_jax()
    from nextpolish_tpu.models.cns import calib

    os.environ["NPT_CNS_CALIB"] = path
    t0 = time.perf_counter()
    eng = calib.choose_engine("ont")
    with open(path) as fh:
        rec = json.load(fh)[calib._cache_key("ont")]
    report("calib", wall_s=time.perf_counter() - t0,
           peak_bytes_in_use=peak_bytes(jax), **rec)
    assert rec["engine"] == eng
    return rec


# ---------------------------------------------------------------------------
# phase 4: four cards
# ---------------------------------------------------------------------------

def phase_multi(n_devices=4):
    jax = init_jax()
    devs = jax.devices()
    assert len(devs) >= n_devices, f"need {n_devices} devices: {devs}"
    devs = devs[:n_devices]
    from nextpolish_tpu.align.index import GenomeIndex
    from nextpolish_tpu.align.longread import map_long_batch
    from nextpolish_tpu.align.mapper import map_short_batch, \
        records_to_batch
    from nextpolish_tpu.io.fasta import read_fastx
    from nextpolish_tpu.models import score_chain as sc
    from nextpolish_tpu.models.cns.batcher import CnsBatcher
    from nextpolish_tpu.models.ctg_cns import ctg_cns_contig
    from nextpolish_tpu.models.score_chain import (
        AlgoConfig,
        score_chain_pipeline,
        score_chain_pipeline_multichip,
    )
    from nextpolish_tpu.parallel.shard import reads_mesh
    from nextpolish_tpu.runtime.overlap import pipelined_map

    os.environ["NPT_CNS_ENGINE"] = "device"
    wd = os.path.join(WORK, "multi")
    t0 = time.perf_counter()
    # phase 3's contigs plus 30 small ones, so that window groups and
    # contigs outnumber the cards; read depth cut (MULTI_DEPTH) because
    # four cards are held for the whole call
    paths = simulate(wd, contigs=MULTI_CONTIGS, **MULTI_DEPTH)
    draft = [(r.name, r.seq) for r in read_fastx(paths["draft"])]
    ont = [r.seq for r in read_fastx(paths["ont"])]
    r1 = [r.seq for r in read_fastx(paths["r1"])]
    r2 = [r.seq for r in read_fastx(paths["r2"])]
    pe = [x for pair in zip(r1, r2) for x in pair]
    lidx = GenomeIndex.build(draft, k=15, w=10)
    lbatch = records_to_batch(map_long_batch(lidx, ont), lidx)
    sidx = GenomeIndex.build(draft, k=17, w=7)
    sbatch = records_to_batch(map_short_batch(sidx, pe, paired=True), sidx)
    report("phase multi_prep", wall_s=time.perf_counter() - t0)
    cfg = AlgoConfig()
    launches = {}  # (task, n devices) -> launches per device

    def task5(ds):
        bat = CnsBatcher("ont", devices=ds)
        out = list(pipelined_map(
            lambda nd: (nd[0], ctg_cns_contig(nd[0], nd[1], lbatch, "ont",
                                              split=0, batcher=bat)),
            draft, depth=8))
        launches["task5", len(ds)] = [bat.launches[d] for d in ds]
        return out

    # count where task 1 sends its contig groups (one device: None)
    placed = {}
    dispatch = sc.dispatch_chain_group

    def counted(handles, device=None):
        placed[device] = placed.get(device, 0) + 1
        return dispatch(handles, device=device)

    sc.dispatch_chain_group = counted

    def task1(ds):
        placed.clear()
        out = list(score_chain_pipeline(draft, sbatch, cfg, devices=ds))
        launches["task1", len(ds)] = [
            placed.get(d if len(ds) > 1 else None, 0) for d in ds]
        return out

    big = [draft[0]]
    out = {}
    for tag, ds in (("4", devs), ("1", devs[:1])):
        for name, fn in (("task5", task5), ("task1", task1)):
            t0 = time.perf_counter()
            out[name, tag] = fn(ds)
            report(f"run multi {name}", devices=len(ds),
                   wall_s=time.perf_counter() - t0,
                   launches_per_device=launches[name, len(ds)])
        t0 = time.perf_counter()
        out["router", tag] = list(score_chain_pipeline_multichip(
            big, sbatch, cfg, mesh=reads_mesh(len(ds)), shard_min=0))
        report("run multi reads_psum_router", devices=len(ds),
               bases=len(big[0][1]), wall_s=time.perf_counter() - t0)
    for name in ("task5", "task1"):
        assert all(launches[name, n_devices]), \
            f"{name}: a card got no launch: {launches[name, n_devices]}"
    for name in ("task5", "task1", "router"):
        assert out[name, "4"] == out[name, "1"], \
            f"{name}: {n_devices} devices != 1 device"
        report(f"parity multi {name}", devices=n_devices, equal=True)
    report("phase multi", peak_bytes_in_use=[
        (d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs])
    return {"device": device_info(jax)}


# ---------------------------------------------------------------------------
# parent
# ---------------------------------------------------------------------------

CHILD_PHASES = {
    "kernels": lambda a: phase_kernels(),
    "accuracy": lambda a: phase_accuracy(*a),
    "calib": lambda a: phase_calib(*a),
    "multi": lambda a: phase_multi(int(a[0])),
}


def run_child(phase: str, *args) -> dict:
    """Run one phase in a child process; returns its RESULT payload."""
    env = dict(os.environ, **GPU_ENV)
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                          "--child", phase, *map(str, args)],
                         stdout=subprocess.PIPE, text=True, env=env,
                         cwd=ROOT)
    result = None
    for line in p.stdout:
        if line.startswith("RESULT "):
            result = json.loads(line[7:])
        else:
            sys.stdout.write(line)
            sys.stdout.flush()
    if p.wait() != 0 or result is None:
        raise SystemExit(f"phase {phase} failed (exit code {p.returncode})")
    report(f"phase {phase} done", wall_s=time.perf_counter() - t0)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    ap.add_argument("--child", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        res = CHILD_PHASES[args.child[0]](args.child[1:])
        print("RESULT " + json.dumps(res, default=str), flush=True)
        return 0
    if not os.path.isdir(os.path.join(ROOT, "nextpolish_tpu")):
        sys.stderr.write("chip_smoke.py must run from a checkout of the "
                         "repository\n")
        return 2
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    except (OSError, subprocess.CalledProcessError) as e:
        sys.stderr.write(f"no NVIDIA GPU: nvidia-smi failed ({e})\n")
        return 2
    os.environ["NPT_SMOKE_CARD"] = card[0]
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    subprocess.run(["make", "-B", "-C",
                    os.path.join(ROOT, "nextpolish_tpu", "native")],
                   check=True, capture_output=True)
    report("phase setup", wall_s=time.perf_counter() - t0,
           built="nextpolish_tpu/native/libnpt.so")

    if args.devices == 4:
        dev = run_child("multi", 4)["device"]
    else:
        dev = run_child("kernels")["device"]
        gpu_tests()
        paths = phase_e2e()
        run_child("accuracy", paths["truth"], paths["draft"],
                  os.path.join(paths["work"], "genome.nextpolish.fasta"))
        run_child("calib", os.path.join(WORK, "calib.json"))
    report("total", wall_s=time.perf_counter() - t_all)
    print(", ".join(card))
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
