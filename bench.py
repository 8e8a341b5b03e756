"""Benchmarks on one device, with the reference engines as the
denominator when they can be built.

Two workloads, both with the hard paths exercised:

1. task 1 (score_chain): 12 contigs x 100 kb at 40x short-read
   coverage with substitutions, insertions, deletions and soft-clipped
   reads (mixed-op CIGARs -> insert cells, clip handling, region
   rescue).  12 contigs so the software pipeline reaches steady state
   (prep/transfer/launch overlap).
2. task 5 (ONT ctg_cns): 8 contigs x 50 kb at ~30x simulated ONT reads
   through the built-in long-read mapper, polished end to end (window
   consensus incl. LQ repair).

The reference NextPolish engines (built by tools/build_ref_oracle.sh
from a reference source tree, when one is present) run on the SAME
fasta+BAM via ctypes, single-core; without them the reference fields are
null and no ratio is printed.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))

REFBUILD = "/tmp/refbuild"


# ---------------------------------------------------------------------------
# task-1 workload: mixed-op CIGARs
# ---------------------------------------------------------------------------

def _sim_read(rng, true, s, ref_span, bases, p_ins=0.002, p_del=0.002,
              p_sub=0.01):
    """Noisy copy of true[s:s+ref_span] with its exact CIGAR, fully
    vectorized.  Single-base ins/del/sub events; returns
    (seq_bytes, [(op, len)]) with op 0=M 1=I 2=D."""
    seg = true[s:s + ref_span]
    n = len(seg)
    ins = rng.random(n) < p_ins  # insert one base before position i
    dele = rng.random(n) < p_del
    sub = (rng.random(n) < p_sub) & ~dele
    out = seg.copy()
    nsub = int(sub.sum())
    if nsub:
        out[sub] = rng.choice(bases, nsub)
    # per position: optional I slot (random base), then an M/D slot
    n_out = ins.astype(np.int64) + 1
    off = np.cumsum(n_out) - n_out
    total = int(n_out.sum())
    seq = np.empty(total, dtype=np.uint8)
    seq[off[ins]] = rng.choice(bases, int(ins.sum()))
    seq[off + ins] = np.where(dele, 0, out)
    ops = np.empty(total, dtype=np.uint8)
    ops[off[ins]] = 1
    ops[off + ins] = np.where(dele, 2, 0)
    # deletions consume no query: drop their seq slots
    qmask = np.ones(total, dtype=bool)
    qmask[(off + ins)[dele]] = False
    seq = seq[qmask]
    # run-length encode ops
    brk = np.flatnonzero(np.diff(ops.astype(np.int8)) != 0)
    starts_r = np.concatenate([[0], brk + 1])
    ends_r = np.concatenate([brk + 1, [len(ops)]])
    cig = [(int(ops[a]), int(b - a)) for a, b in zip(starts_r, ends_r)]
    return seq.tobytes(), cig


def make_task1_case(rng, L=100_000, depth=40, read_len=150, n_contigs=12,
                    clip_frac=0.02, p_indel=0.002, p_sub=0.01):
    from nextpolish_tpu.io.bam import AlnBatch, BamHeader
    from nextpolish_tpu.io.fasta import ASCII_TO_NIB

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    names = [f"ctg{i}" for i in range(n_contigs)]
    header = BamHeader("", names, [L] * n_contigs)
    trues = []
    rows = []  # (tid, pos, seq, cigar)
    per = depth * L // read_len
    for i in range(n_contigs):
        true = rng.choice(bases, L)
        trues.append(true.tobytes())
        starts = np.sort(rng.integers(0, L - read_len - 10, per))
        # most reads are gapless (vectorized); a Poisson-sampled subset
        # carries explicit insertion/deletion events so the engine's
        # insert cells and mixed-CIGAR paths see real work
        n_ev = rng.poisson(2 * p_indel * read_len, per)
        gapless = n_ev == 0
        seqs = true[starts[:, None] + np.arange(read_len)[None, :]].copy()
        n_err = int(p_sub * seqs.size)
        er = rng.integers(0, per, n_err)
        ec = rng.integers(0, read_len, n_err)
        seqs[er, ec] = rng.choice(bases, n_err)
        base_cig = [(0, read_len)]
        for j in range(per):  # emitted in sorted-position order
            if gapless[j]:
                rows.append((i, int(starts[j]), seqs[j].tobytes(),
                             base_cig))
                continue
            seq, cig = _sim_read(rng, true, int(starts[j]), read_len,
                                 bases, p_ins=p_indel, p_del=p_indel,
                                 p_sub=p_sub)
            if rng.random() < clip_frac:
                extra = rng.choice(bases, 10).tobytes()
                if rng.random() < 0.5:
                    seq = extra + seq
                    cig = [(4, 10)] + cig
                else:
                    seq = seq + extra
                    cig = cig + [(4, 10)]
            rows.append((i, int(starts[j]), seq, cig))
    n = len(rows)
    lq = np.array([len(r[2]) for r in rows], dtype=np.int32)
    seq_off = np.concatenate([[0], np.cumsum(lq[:-1])]).astype(np.int64)
    cig_arr = []
    cig_off = []
    off = 0
    for _, _, _, cig in rows:
        cig_off.append(off)
        for op, ln in cig:
            cig_arr.append((ln << 4) | op)
        off += len(cig)
    seqcat = np.frombuffer(b"".join(r[2] for r in rows), dtype=np.uint8)
    batch = AlnBatch(
        header=header,
        tid=np.array([r[0] for r in rows], np.int32),
        pos=np.array([r[1] for r in rows], np.int32),
        mapq=np.full(n, 60, np.uint8),
        flag=np.zeros(n, np.uint16),
        tlen=np.where(np.arange(n) % 2 == 0, 300, -300).astype(np.int32),
        lqseq=lq,
        cigar=np.array(cig_arr, dtype=np.uint32),
        cigar_off=np.array(cig_off, dtype=np.int64),
        cigar_len=np.array([len(r[3]) for r in rows], np.int32),
        seq=ASCII_TO_NIB[seqcat],
        seq_off=seq_off,
        qual=np.full(int(lq.sum()), 35, np.uint8),
        qual_off=seq_off.copy(),
        mtid=np.full(n, -1, np.int32),
        mpos=np.full(n, -1, np.int32),
    )
    return names, trues, batch, n


# ---------------------------------------------------------------------------
# task-5 workload: simulated ONT long reads through the built-in mapper
# ---------------------------------------------------------------------------

def make_task5_case(rng, L=50_000, n_contigs=8, depth=30, err=0.03):
    from nextpolish_tpu.align.index import GenomeIndex
    from nextpolish_tpu.align.longread import map_long_batch
    from nextpolish_tpu.align.mapper import records_to_batch

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    names, drafts, reads_all = [], [], []
    for i in range(n_contigs):
        true = rng.choice(bases, L)
        # draft = lightly corrupted truth
        d, _ = _sim_read(rng, true, 0, L, bases, 0.003, 0.003, 0.006)
        names.append(f"ctg{i}")
        drafts.append(d)
        n_reads = depth * L // 3000
        for _ in range(n_reads):
            a = int(rng.integers(0, max(L - 4000, 1)))
            b = min(a + int(rng.integers(2500, 4000)), L)
            r, _ = _sim_read(rng, true, a, b - a, bases, err, err, err)
            if rng.random() < 0.5:
                r = r.translate(comp)[::-1]
            reads_all.append((i, r))
    idx = GenomeIndex.build(list(zip(names, drafts)), k=15, w=10)
    recs = map_long_batch(idx, [r for _, r in reads_all])
    batch = records_to_batch(recs, idx)
    return names, drafts, batch


# ---------------------------------------------------------------------------
# measured reference baselines (single core, same inputs)
# ---------------------------------------------------------------------------

def ensure_refbuild() -> bool:
    if os.path.exists(os.path.join(REFBUILD, "lib", "nextpolish2.so")):
        return True
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tools", "build_ref_oracle.sh")
    try:
        subprocess.run(["bash", script], check=True, capture_output=True,
                       timeout=900)
        return True
    except Exception:
        return False


def _write_inputs(workdir, names, seqs, batch):
    from ref_parity import batch_to_bam, write_fai

    os.makedirs(workdir, exist_ok=True)
    fa = os.path.join(workdir, "genome.fa")
    with open(fa, "wb") as fh:
        for n, s in zip(names, seqs):
            fh.write(b">%s\n%s\n" % (n.encode(), s))
    write_fai(fa)
    bam = os.path.join(workdir, "reads.sort.bam")
    batch_to_bam(batch, bam)
    return fa, bam


def measure_ref_task1(names, trues, batch, workdir) -> float | None:
    """Reference score_chain wall time (single core) -> reads/s."""
    from ref_parity import load_ref_lib, run_reference

    try:
        fa, bam = _write_inputs(workdir, names, trues, batch)
        lib = load_ref_lib()
        t0 = time.time()
        run_reference(lib, "score_chain", fa, bam)
        dt = time.time() - t0
        return len(batch) / dt
    except Exception as e:
        print(f"ref task1 measurement failed: {e!r}", file=sys.stderr)
        return None


def measure_ref_task5(names, drafts, batch, workdir) -> float | None:
    """Reference ctg_cns wall time (single core) -> draft bases/s."""
    from ref_parity2 import load_ref2, run_reference_cns

    try:
        fa, bam = _write_inputs(workdir, names, drafts, batch)
        lib = load_ref2()
        t0 = time.time()
        run_reference_cns(lib, fa, bam, "ont")
        dt = time.time() - t0
        return sum(len(d) for d in drafts) / dt
    except Exception as e:
        print(f"ref task5 measurement failed: {e!r}", file=sys.stderr)
        return None


# ---------------------------------------------------------------------------
# kernel-level timings: host clock around launches that end in
# block_until_ready, on pre-placed inputs
# ---------------------------------------------------------------------------

def _time_launch(launch, reps=3) -> float:
    import jax

    jax.block_until_ready(launch())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(launch())
        best = min(best, time.perf_counter() - t0)
    return best


def measure_cns_kernel(read_type="ont"):
    """Per-launch device time of the engine-2 level-scan kernel on a
    B_MAX batch of probe windows."""
    import jax

    from nextpolish_tpu.models.cns import device_dp as dd
    from nextpolish_tpu.models.cns.calib import PROBE_LEN, _probe_window
    from nextpolish_tpu.models.cns.dp import COV_COEF

    merged, coverage, L = _probe_window(read_type)
    edges, dw = dd.prepare_window(merged, coverage, L)
    pk = dd.pack_group([dw] * dd.B_MAX)
    B, P = pk.lvl.shape
    fn = dd.get_scan(dd._use_kernel(), pk.E, pk.Vb,
                     dd.READ_TYPE_ID[read_type], COV_COEF[read_type], B,
                     pk.NCL, P)
    args = jax.device_put(pk.args())
    t = _time_launch(lambda: fn(*args))
    lv = max(pk.Lts)
    return {
        "launch_s": round(t, 5),
        "per_level_us": round(t / lv * 1e6, 4),
        "kernel_bases_per_s": round(B * PROBE_LEN / t, 1),
        "device_kind": jax.devices()[0].device_kind,
    }


def measure_chain_kernel(prep_handle):
    """Per-launch device time of the task-1 chain DP on a
    production-shaped problem (a _ChainHandle from the bench workload),
    with roofline shares against the device's published FP32 and HBM
    peaks (runtime.roofline: a (max,+) kernel tops out at a 0.5 share)."""
    import jax

    from nextpolish_tpu.ops import tropical as tr
    from nextpolish_tpu.runtime import roofline

    kind, shape = prep_handle.key[0], prep_handle.key[1:]
    L = prep_handle.L
    bufd = jax.device_put(prep_handle.buf)
    kfn = (tr.chain_correct_planes if kind == "planes"
           else tr.chain_correct_packed)
    t = _time_launch(lambda: kfn(bufd, *shape))
    peak_f, peak_b, dkind = roofline.device_peaks()
    return {
        "launch_s": round(t, 5),
        "per_cell_ns": round(t / L * 1e9, 2),
        "flops_share": round(roofline.chain_flops(L) / t / peak_f, 5),
        "membw_share": round(roofline.chain_bytes(L) / t / peak_b, 4),
        "kernel_cells_per_s": round(L / t, 1),
        "device_kind": dkind,
    }


# ---------------------------------------------------------------------------

def main():
    import tempfile

    rng = np.random.default_rng(0)
    have_ref = ensure_refbuild()
    tmp = tempfile.mkdtemp(prefix="npt_bench_")
    from nextpolish_tpu.runtime import trace

    # ---- task 1 -------------------------------------------------------
    names, trues, batch, n_reads = make_task1_case(rng)
    from nextpolish_tpu.models.score_chain import (
        AlgoConfig,
        score_chain_pipeline,
    )

    cfg = AlgoConfig()

    def run_some(k):
        return list(score_chain_pipeline(zip(names[:k], trues[:k]), batch,
                                         cfg))

    polished = run_some(len(names))  # compile pass
    for (_, seq), true in zip(polished, trues):
        assert abs(len(seq) - len(true)) < len(true) * 0.01
    # batch-scaling curve (contigs per run)
    scaling = {}
    for k in (1, 4, 12):
        d = float("inf")
        for _ in range(2):
            t0 = time.time()
            run_some(k)
            d = min(d, time.time() - t0)
        scaling[k] = round(n_reads * k / len(names) / d, 1)
    trace.reset("task1")
    dt = float("inf")
    t1_runs = []
    for _ in range(3):
        t0 = time.time()
        run_some(len(names))
        d = time.time() - t0
        t1_runs.append(round(n_reads / d, 1))
        dt = min(dt, d)
    t1_reads_per_s = n_reads / dt
    t1_trace = trace.snapshot("task1")

    ref1 = measure_ref_task1(names, trues, batch,
                             os.path.join(tmp, "t1")) if have_ref else None
    vs_t1 = t1_reads_per_s / (ref1 * 32) if ref1 is not None else None

    # ---- task 5 -------------------------------------------------------
    names5, drafts5, batch5 = make_task5_case(rng)
    from nextpolish_tpu.models.ctg_cns import ctg_cns_contig

    from nextpolish_tpu.runtime.overlap import pipelined_map

    def run_cns():
        # contig-level pipelining + the shared cross-contig window
        # batcher, exactly as worker2/pipeline run it (worker2.py:98-117)
        from nextpolish_tpu.models.cns.batcher import CnsBatcher
        from nextpolish_tpu.models.cns.window import default_engine

        batcher = None
        depth = 2
        if default_engine() == "device":
            batcher = CnsBatcher("ont")
            depth = max(2, batcher.B)
        out = []
        for parts in pipelined_map(
                lambda nd: ctg_cns_contig(nd[0], nd[1], batch5, "ont",
                                          batcher=batcher),
                list(zip(names5, drafts5)), depth=depth):
            out.extend(parts)
        return out

    if os.environ.get("NPT_CNS_ENGINE") is None:
        os.environ["NPT_CNS_ENGINE"] = "device"
    out5 = run_cns()  # compile pass
    run_cns()  # second pass: the cross-contig batcher composes groups
    # nondeterministically, so one pass may miss some (B, P) buckets
    assert sum(len(s) for _, s in out5) > 0.9 * sum(
        len(d) for d in drafts5)
    trace.reset("cns")
    dt5 = float("inf")
    t5_runs = []
    nb5 = sum(len(d) for d in drafts5)
    for _ in range(2):
        t0 = time.time()
        run_cns()
        d = time.time() - t0
        t5_runs.append(round(nb5 / d, 1))
        dt5 = min(dt5, d)
    t5_bases_per_s = nb5 / dt5
    t5_trace = trace.snapshot("cns")
    # the host C++ engine number alongside the device path
    os.environ["NPT_CNS_ENGINE"] = "native"
    run_cns()
    t0 = time.time()
    run_cns()
    t5_native = sum(len(d) for d in drafts5) / (time.time() - t0)
    os.environ["NPT_CNS_ENGINE"] = "device"

    ref5 = measure_ref_task5(names5, drafts5, batch5,
                             os.path.join(tmp, "t5")) if have_ref else None
    vs_t5_core = (t5_bases_per_s / ref5) if ref5 else None

    # what would production auto-select on this host? (calib probe,
    # fresh — not the cached file)
    from nextpolish_tpu.models.cns.calib import measure_engines

    rates = measure_engines("ont")
    auto_eng = "device" if rates["device"] >= rates["native"] else "native"
    t5_auto = t5_bases_per_s if auto_eng == "device" else t5_native

    def split(tr, wait_key):
        """host/device-wait seconds + host-busy fraction from the trace."""
        host = sum(v["s"] for k, v in tr.items() if k.endswith(".host"))
        wait = sum(v["s"] for k, v in tr.items() if wait_key in k)
        tot = host + wait
        return {"host_s": round(host, 2), "device_wait_s": round(wait, 2),
                "host_busy_frac": round(host / tot, 2) if tot else None}

    # ---- kernel-level times + device-busy estimates ---------------------
    from nextpolish_tpu.models.score_chain import score_chain_contig_prep

    cns_k = measure_cns_kernel("ont")
    chain_k = measure_chain_kernel(
        score_chain_contig_prep(names[0], trues[0], batch, cfg))
    n5 = max(len(t5_runs), 1)  # trace accumulated over the timed runs
    n1 = max(len(t1_runs), 1)
    t5_busy = t1_busy = None
    if cns_k and "cns.levels" in t5_trace:
        lv = t5_trace["cns.levels"]["s"] / n5
        t5_busy = round(lv * cns_k["per_level_us"] * 1e-6 / dt5, 4)
    if chain_k and "task1.chain_cells" in t1_trace:
        cells = t1_trace["task1.chain_cells"]["s"] / n1
        t1_busy = round(
            cells * chain_k["per_cell_ns"] * 1e-9 / dt, 4)

    print(json.dumps({
        "metric": "task1_polish_reads_per_s_per_device",
        "value": round(t1_reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(vs_t1, 3) if vs_t1 is not None else None,
        "ref_measured": ref1 is not None,
        "ref_task1_reads_per_s_core": round(ref1, 1) if ref1 else None,
        "task1_runs": t1_runs,
        "task1_scaling_reads_per_s_by_contigs": scaling,
        "task1_time_split": split(t1_trace, ".wait"),
        "task1_device_busy_frac": t1_busy,
        "task1_chain_kernel": chain_k,
        "task5_bases_per_s_per_device": round(t5_bases_per_s, 1),
        "task5_runs": t5_runs,
        "task5_bases_per_s_native_engine": round(t5_native, 1),
        "ref_task5_bases_per_s_core": round(ref5, 1) if ref5 else None,
        "task5_vs_ref_core": round(vs_t5_core, 2) if vs_t5_core else None,
        "task5_time_split": split(t5_trace, ".dp"),
        "task5_device_busy_frac": t5_busy,
        "task5_scan_kernel": cns_k,
        "task5_engine_auto": auto_eng,
        "task5_bases_per_s_auto": round(t5_auto, 1),
        "cns_engine": os.environ.get("NPT_CNS_ENGINE"),
    }))


if __name__ == "__main__":
    if "--scale" in sys.argv:
        # O(window) data-plane stress: full pipeline on
        # a simulated multi-Mb genome with the spill plane forced on,
        # asserting bounded peak RSS.  See tools/scale_stress.py.
        from scale_stress import main as scale_main

        sys.exit(scale_main([a for a in sys.argv[1:] if a != "--scale"]))
    main()
