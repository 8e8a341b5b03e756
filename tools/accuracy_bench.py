#!/usr/bin/env python3
"""Truth-based accuracy benchmark: our stack vs the reference stack.

Mirrors the reference's own validation protocols (doc/TEST1.rst,
doc/TEST3.rst): simulate reads from a known truth genome, derive an
error-injected draft, polish the draft with (a) this repo's pipeline
(built-in mapper + device engines) and (b) the reference NextPolish stack
(vendored bwa/minimap2/samtools + its own engines, built by
tools/build_ref_oracle.sh into /tmp/refbuild), then count residual
mismatches / indel bases per 100 kbp against the truth.

Modes:
  ont  — TEST3 analog: noisy-long-read draft polished with ONT reads,
         2 rounds of task 5 (ctg_cns), tutorial loop semantics
         (doc/TUTORIAL.rst:131-149).
  sgs  — TEST1 analog: near-finished draft polished with PE150 short
         reads, 2 rounds of tasks [1,2] (score_chain + kmer_count),
         full map->fixmate->sort->markdup chain per task
         (source/nextPolish:199-206,119-156).

Usage: python tools/accuracy_bench.py [--mode both] [--size 200000]
       [--rounds 2] [--seed 0] [--refbuild /tmp/refbuild] [--skip-ref]
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


# ----------------------------------------------------------------- simulators

def sim_genome(rng, size: int) -> bytes:
    """Random genome with a few duplicated segments (mapping ambiguity)."""
    g = bytearray(rng.choice(BASES, size).tobytes())
    # plant 4 near-identical repeats of a 3 kb segment (~1% divergence)
    seg_len = min(3000, size // 20)
    src = int(rng.integers(0, size - seg_len))
    seg = bytearray(g[src:src + seg_len])
    for _ in range(3):
        s2 = bytearray(seg)
        for _ in range(seg_len // 100):
            p = int(rng.integers(0, seg_len))
            s2[p] = int(rng.choice(BASES))
        dst = int(rng.integers(0, size - seg_len))
        g[dst:dst + seg_len] = s2
    return bytes(g)


def mutate(rng, seq: bytes, sub_rate: float, ind_rate: float) -> bytes:
    """Error-injected draft: substitutions + 1-3 bp indels."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    n = arr.size
    out = []
    n_sub = int(sub_rate * n)
    n_ind = int(ind_rate * n / 2)  # events; ~2 bases per event
    sub_pos = set(map(int, rng.integers(0, n, n_sub)))
    ind_pos = {int(p): (int(rng.integers(0, 2)), int(rng.integers(1, 4)))
               for p in rng.integers(0, n, n_ind)}
    i = 0
    while i < n:
        if i in ind_pos:
            kind, ln = ind_pos[i]
            if kind == 0:  # deletion from truth
                i += ln
                continue
            out.append(rng.choice(BASES, ln).tobytes())
        b = arr[i]
        if i in sub_pos:
            b = BASES[(np.searchsorted(BASES, b) + 1 + int(rng.integers(0, 3))) % 4]
        out.append(bytes([b]))
        i += 1
    return b"".join(out)


def sim_long_reads(rng, genome: bytes, depth: float, mean_len: int,
                   sub: float, ins: float, dele: float):
    """ONT-like reads; returns list[bytes]."""
    n_bases = int(depth * len(genome))
    reads = []
    got = 0
    g = np.frombuffer(genome, dtype=np.uint8)
    L = len(genome)
    while got < n_bases:
        ln = int(np.clip(rng.gamma(3.0, mean_len / 3.0), 1000, 4 * mean_len))
        ln = min(ln, L - 1)
        start = int(rng.integers(0, L - ln))
        frag = g[start:start + ln]
        r = rng.random(ln)
        keep = r >= dele
        frag = frag[keep]
        r = r[keep]
        do_sub = r < dele + sub  # disjoint from the deleted range
        subs = rng.choice(BASES, int(do_sub.sum()))
        frag = frag.copy()
        frag[do_sub] = np.where(
            subs == frag[do_sub],
            BASES[(np.searchsorted(BASES, subs) + 1) % 4], subs)
        do_ins = rng.random(frag.size) < ins
        if do_ins.any():
            idx = np.flatnonzero(do_ins)
            frag = np.insert(frag, idx, rng.choice(BASES, idx.size))
        if rng.random() < 0.5:
            frag = np.array([3, 2, 1, 0, 0], dtype=np.uint8)[
                np.searchsorted(BASES, frag)][::-1]
            frag = BASES[np.clip(frag, 0, 3)]
        reads.append(frag.tobytes())
        got += frag.size
    return reads


def sim_pe_reads(rng, genome: bytes, depth: float, rlen: int = 150,
                 isize: int = 300, isize_sd: int = 30, err: float = 0.002):
    """PE150 FR pairs; returns (list[r1], list[r2])."""
    g = np.frombuffer(genome, dtype=np.uint8)
    L = len(genome)
    n_pairs = int(depth * L / (2 * rlen))
    comp = np.zeros(256, np.uint8)
    comp[ord("A")], comp[ord("C")] = ord("T"), ord("G")
    comp[ord("G")], comp[ord("T")] = ord("C"), ord("A")
    r1s, r2s = [], []
    ins = np.clip(rng.normal(isize, isize_sd, n_pairs).astype(int),
                  rlen + 10, 2 * isize)
    starts = rng.integers(0, np.maximum(L - ins, 1))
    for i in range(n_pairs):
        s, iln = int(starts[i]), int(ins[i])
        fwd = g[s:s + rlen].copy()
        rev = comp[g[s + iln - rlen:s + iln]][::-1].copy()
        for arr in (fwd, rev):
            e = rng.random(arr.size) < err
            if e.any():
                idx = np.flatnonzero(e)
                repl = rng.choice(BASES, idx.size)
                arr[idx] = np.where(repl == arr[idx],
                                    BASES[(np.searchsorted(BASES, repl) + 1) % 4],
                                    repl)
        if rng.random() < 0.5:
            r1s.append(fwd.tobytes()); r2s.append(rev.tobytes())
        else:
            r1s.append(rev.tobytes()); r2s.append(fwd.tobytes())
    return r1s, r2s


# ------------------------------------------------------------------- file I/O

def write_fasta(path, seqs: dict):
    with open(path, "w") as f:
        for name, s in seqs.items():
            f.write(f">{name}\n")
            for i in range(0, len(s), 80):
                f.write(s[i:i + 80].decode() if isinstance(s, bytes)
                        else s[i:i + 80])
                f.write("\n")


def write_reads_fa_gz(path, reads):
    with gzip.open(path, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r.decode()}\n")


def write_fastq_gz(path, reads, suffix):
    with gzip.open(path, "wt") as f:
        for i, r in enumerate(reads):
            q = "I" * len(r)
            f.write(f"@p{i}{suffix}\n{r.decode()}\n+\n{q}\n")


def read_fasta(path) -> dict:
    seqs, name, buf = {}, None, []
    for line in open(path):
        if line.startswith(">"):
            if name:
                seqs[name] = "".join(buf)
            name, buf = line[1:].split()[0], []
        else:
            buf.append(line.strip())
    if name:
        seqs[name] = "".join(buf)
    return seqs


# ------------------------------------------------------------ error counting

def asm_error(polished_fa: str, truth_fa: str, minimap2: str | None):
    """(mismatches, indel_bases, aligned_bases) of polished vs truth."""
    if minimap2 and os.path.exists(minimap2):
        out = subprocess.run(
            [minimap2, "-cx", "asm20", "--cs", "-t8", truth_fa, polished_fa],
            capture_output=True, text=True, check=True).stdout
        mm = ind = aln = 0
        for line in out.splitlines():
            f = line.split("\t")
            if len(f) < 12 or not int(f[11]) >= 0:
                continue
            cs = next((x[5:] for x in f[12:] if x.startswith("cs:Z:")), "")
            for op, val in re.findall(r"([:*+\-])([A-Za-z0-9]+)", cs):
                if op == ":":
                    aln += int(val)
                elif op == "*":
                    mm += 1
                    aln += 1
                else:
                    ind += len(val)
        return mm, ind, aln
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from asm_stats import asm_stats  # fallback: built-in mapper
    return asm_stats(polished_fa, truth_fa)


# ----------------------------------------------------------------- ref stack

def ref_polish_ont(wd, draft, lgs_reads_gz, rounds, refbuild):
    mm2 = os.path.join(refbuild, "util/minimap2/minimap2")
    st = os.path.join(refbuild, "util/samtools/samtools")
    np2 = os.path.join(refbuild, "lib/nextpolish2.py")
    inp = draft
    for i in range(rounds):
        bam = os.path.join(wd, f"lgs.r{i}.bam")
        p1 = subprocess.Popen([mm2, "-ax", "map-ont", "-t8", inp, lgs_reads_gz],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL)
        subprocess.run([st, "sort", "-", "-m", "2g", "-o", bam],
                       stdin=p1.stdout, check=True,
                       stderr=subprocess.DEVNULL)
        p1.wait()
        subprocess.run([st, "index", bam], check=True)
        fofn = bam + ".fofn"
        open(fofn, "w").write(bam + "\n")
        out = os.path.join(wd, f"ref.ont.r{i + 1}.fa")
        if os.path.exists(out):
            os.unlink(out)
        subprocess.run([sys.executable, np2, "-g", inp, "-l", fofn, "-r",
                        "ont", "-p", "8", "-o", out], check=True,
                       stderr=subprocess.DEVNULL)
        inp = out
    return inp


def ref_polish_sgs(wd, draft, r1_gz, r2_gz, rounds, refbuild):
    bwa = os.path.join(refbuild, "util/bwa/bwa")
    st = os.path.join(refbuild, "util/samtools/samtools")
    np1 = os.path.join(refbuild, "lib/nextpolish1.py")
    inter = os.path.join(wd, "inter.fastq.gz")
    with gzip.open(inter, "wb") as o, gzip.open(r1_gz, "rb") as a, \
            gzip.open(r2_gz, "rb") as b:
        while True:
            x = [a.readline() for _ in range(4)]
            y = [b.readline() for _ in range(4)]
            if not x[0]:
                break
            for l in x + y:
                o.write(l)
    inp = draft
    step = 0
    for _ in range(rounds):
        for task in (1, 2):
            step += 1
            pre = os.path.join(wd, f"g{step}")
            shutil.copy(inp, pre + ".fa")
            subprocess.run([bwa, "index", "-p", pre + ".sgs", pre + ".fa"],
                           check=True, stderr=subprocess.DEVNULL)
            subprocess.run([st, "faidx", pre + ".fa"], check=True)
            bam = pre + ".sort.bam"
            p1 = subprocess.Popen([bwa, "mem", "-p", "-t8", pre + ".sgs",
                                   inter], stdout=subprocess.PIPE,
                                  stderr=subprocess.DEVNULL)
            p2 = subprocess.Popen([st, "view", "-F", "0x4", "-b", "-"],
                                  stdin=p1.stdout, stdout=subprocess.PIPE,
                                  stderr=subprocess.DEVNULL)
            p3 = subprocess.Popen([st, "fixmate", "-m", "-", "-"],
                                  stdin=p2.stdout, stdout=subprocess.PIPE,
                                  stderr=subprocess.DEVNULL)
            subprocess.run([st, "sort", "-", "-m", "2g", "-o", bam],
                           stdin=p3.stdout, check=True,
                           stderr=subprocess.DEVNULL)
            for p in (p1, p2, p3):
                p.wait()
            mbam = pre + ".md.bam"
            subprocess.run([st, "markdup", "-r", bam, mbam], check=True,
                           stderr=subprocess.DEVNULL)
            subprocess.run([st, "index", mbam], check=True)
            out = os.path.join(wd, f"ref.sgs.s{step}.fa")
            if os.path.exists(out):
                os.unlink(out)
            subprocess.run([sys.executable, np1, "-g", pre + ".fa", "-s",
                            mbam, "-t", str(task), "-p", "8", "-o", out],
                           check=True, stderr=subprocess.DEVNULL)
            inp = out
    return inp


# ----------------------------------------------------------------- our stack

def ours_polish(wd, draft, task_string, cfg_lines):
    cfg = os.path.join(wd, "run.cfg")
    work = os.path.join(wd, "work_" + task_string)
    open(cfg, "w").write(
        f"task = {task_string}\ngenome = {draft}\nworkdir = {work}\n"
        + "\n".join(cfg_lines) + "\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run([sys.executable, "-m", "nextpolish_tpu", cfg], check=True,
                   env=env, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    return os.path.join(work, "genome.nextpolish.fasta")


# ----------------------------------------------------------------------- main

def per100k(mm, ind, aln):
    if not aln:
        return float("inf"), float("inf")
    return 1e5 * mm / aln, 1e5 * ind / aln


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="both", choices=["ont", "sgs", "both"])
    ap.add_argument("--size", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--refbuild", default="/tmp/refbuild")
    ap.add_argument("--skip-ref", action="store_true")
    ap.add_argument("--workdir", default=None,
                    help="default: fresh per-run tempdir (concurrent runs "
                         "must not share a workdir)")
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    if args.workdir:
        wd = args.workdir
        shutil.rmtree(wd, ignore_errors=True)
        os.makedirs(wd)
    else:
        import tempfile
        wd = tempfile.mkdtemp(prefix="npt_accuracy_")
    mm2 = os.path.join(args.refbuild, "util/minimap2/minimap2")
    if not os.path.exists(mm2):
        mm2 = None
    have_ref = not args.skip_ref and os.path.exists(
        os.path.join(args.refbuild, "lib/nextpolish2.so"))

    truth = sim_genome(rng, args.size)
    truth_fa = os.path.join(wd, "truth.fa")
    write_fasta(truth_fa, {"chr_t": truth})
    results = []

    def report(tag, fa, secs=None):
        mm, ind, aln = asm_error(fa, truth_fa, mm2)
        m1, i1 = per100k(mm, ind, aln)
        results.append(dict(run=tag, mismatches_per_100k=round(m1, 2),
                            indels_per_100k=round(i1, 2), aligned=aln,
                            seconds=None if secs is None else round(secs, 1)))
        print(f"{tag:24s} mm/100k={m1:9.2f}  ind/100k={i1:9.2f}  "
              f"aligned={aln}" + (f"  [{secs:.1f}s]" if secs else ""))

    if args.mode in ("ont", "both"):
        draft = mutate(rng, truth, sub_rate=0.02, ind_rate=0.02)
        draft_fa = os.path.join(wd, "draft.ont.fa")
        write_fasta(draft_fa, {"ctg1": draft})
        reads = sim_long_reads(rng, truth, depth=40, mean_len=15_000,
                               sub=0.045, ins=0.02, dele=0.025)
        lgs_gz = os.path.join(wd, "lgs.fa.gz")
        write_reads_fa_gz(lgs_gz, reads)
        lgs_fofn = os.path.join(wd, "lgs.fofn")
        open(lgs_fofn, "w").write(lgs_gz + "\n")
        report("ont.draft", draft_fa)
        t0 = time.time()
        ours = ours_polish(wd, draft_fa, "5" * args.rounds, [
            f"lgs_fofn = {lgs_fofn}",
            "lgs_options = -min_read_len 0 -max_depth 100000",
            "lgs_minimap2_options = -x map-ont"])
        report("ont.ours", ours, time.time() - t0)
        if have_ref:
            t0 = time.time()
            ref = ref_polish_ont(wd, draft_fa, lgs_gz, args.rounds,
                                 args.refbuild)
            report("ont.reference", ref, time.time() - t0)

    if args.mode in ("sgs", "both"):
        draft = mutate(rng, truth, sub_rate=0.0005, ind_rate=0.001)
        draft_fa = os.path.join(wd, "draft.sgs.fa")
        write_fasta(draft_fa, {"ctg1": draft})
        r1, r2 = sim_pe_reads(rng, truth, depth=50)
        r1_gz = os.path.join(wd, "sr.R1.fastq.gz")
        r2_gz = os.path.join(wd, "sr.R2.fastq.gz")
        write_fastq_gz(r1_gz, r1, "/1")
        write_fastq_gz(r2_gz, r2, "/2")
        fofn = os.path.join(wd, "sgs.fofn")
        open(fofn, "w").write(r1_gz + "\n" + r2_gz + "\n")
        report("sgs.draft", draft_fa)
        t0 = time.time()
        ours = ours_polish(wd, draft_fa, "12" * args.rounds, [
            f"sgs_fofn = {fofn}", "sgs_options = -max_depth 100"])
        report("sgs.ours", ours, time.time() - t0)
        if have_ref:
            t0 = time.time()
            ref = ref_polish_sgs(wd, draft_fa, r1_gz, r2_gz, args.rounds,
                                 args.refbuild)
            report("sgs.reference", ref, time.time() - t0)

    print(json.dumps({"accuracy_bench": results}))


if __name__ == "__main__":
    main()
