"""Pedantic simulator of the reference consensus DP (verification oracle).

Line-faithful Python mirror of update_msa + get_cns_from_align_tags +
generate_cns_from_best_score's traceback (lib/ctg_cns.c:324-365, 1876-2144,
1828-1874) operating on OUR TagColumns.  Slow (pure Python dict/list code,
same insertion-order semantics as the C link lists) — used only to verify
the vectorized engine in nextpolish_tpu/models/cns/ and to localize
divergence cell-by-cell.  Not part of the production path.
"""
from __future__ import annotations

import os
import sys

INT64_MIN = -(2**63)
GAP = 4


class Entry:
    __slots__ = ("pp", "ppp", "link", "score")

    def __init__(self, pp, ppp):
        self.pp = pp  # (t_pos, delta, q_base) or None (head)
        self.ppp = ppp
        self.link = 1
        self.score = 0


class Cell:
    __slots__ = ("entries", "best")

    def __init__(self):
        self.entries = []  # insertion order
        self.best = 0


def build_msa(cols):
    """update_msa over rows in insertion order; returns dict keyed by
    (t_pos, delta, q_base) -> Cell, plus per-position max delta+1."""
    msa = {}
    n_rows = cols.n_rows()
    for r in range(n_rows):
        t, d, q = cols.row(r)
        pp = ppp = None
        for i in range(len(t)):
            cur = (int(t[i]), int(d[i]), int(q[i]))
            cell = msa.get(cur)
            if cell is None:
                cell = msa[cur] = Cell()
            for e in cell.entries:
                if e.pp == pp and e.ppp == ppp:
                    e.link += 1
                    break
            else:
                cell.entries.append(Entry(pp, ppp))
            ppp = pp
            pp = cur
    return msa


def run_dp(msa, coverage, length, read_type):
    """The per-type scoring + best-entry selection loops."""
    cov_coef = {"ont": 3, "clr": 3, "rs": 3, "hifi": 4}[read_type]
    # group keys per position in (delta, q_base) order like the C loops
    by_pos = [[] for _ in range(length)]
    for key in msa:
        by_pos[key[0]].append(key)
    for p in range(length):
        by_pos[p].sort()

    global_best_score = INT64_MIN
    global_best = None
    for p in range(length):
        covp = int(coverage[p])
        for key in by_pos[p]:
            cell = msa[key]
            cell.best = 0
            p_pp = INT64_MIN  # p_pp_score
            raiser = INT64_MIN  # p_pp_score_ (carries across m!)
            b = key[2]
            if read_type == "ont":
                tmp = 0
                for e in cell.entries:
                    if e.link > tmp:
                        tmp = e.link
            for mi, m in enumerate(cell.entries):
                if m.pp is None:
                    m.score = 10 * m.link - cov_coef * covp
                else:
                    pp_cell = msa[m.pp]
                    for n in pp_cell.entries:
                        if n.pp == m.ppp:
                            cand = n.score + 10 * m.link - cov_coef * covp
                            if cand > m.score:
                                m.score = cand
                                raiser = n.score
                            if read_type in ("clr", "hifi"):
                                if n.score > p_pp or (
                                    n.score == p_pp and m.pp[2] != GAP
                                ):
                                    cell.best = mi
                                    p_pp = n.score
                            elif read_type == "ont":
                                cond1 = (
                                    (m.ppp is not None and m.ppp[1] > 1)
                                    or m.pp[1] > 0
                                ) and (
                                    m.link > covp * 0.2 or m.link > tmp // 2
                                )
                                cond2 = (
                                    m.link
                                    > cell.entries[cell.best].link // 2
                                    and n.score > p_pp
                                    and (
                                        m.pp[2] == GAP
                                        or m.pp[2] == b
                                        or (m.ppp is not None
                                            and m.ppp[2] == b)
                                        or (m.ppp is not None
                                            and m.pp[2] == m.ppp[2])
                                    )
                                )
                                if cond1 or cond2:
                                    cell.best = mi
                                    p_pp = n.score
                # final rule
                if read_type == "rs":
                    if m.score >= cell.entries[cell.best].score:
                        cell.best = mi
                        p_pp = raiser
                else:
                    if m.score > cell.entries[cell.best].score or (
                        m.score == cell.entries[cell.best].score
                        and m.pp is not None
                        and m.pp[2] != GAP
                    ):
                        cell.best = mi
                        p_pp = raiser
            if p == length - 1 and cell.entries:
                sc = cell.entries[cell.best].score
                if sc >= global_best_score:
                    global_best = key
                    if sc > global_best_score:
                        global_best_score = sc
    return global_best


def traceback(msa, coverage, global_best, min_cov=4, lq_min_qv=20):
    """generate_cns_from_best_score emit loop; returns list of
    (t_pos, base_chr, qv) in forward order."""
    int_to_base = "ATGC-N"
    out = []
    cur = global_best
    while cur is not None:
        cell = msa[cur]
        e = cell.entries[cell.best]
        if cur[2] != GAP:
            qv = 100 * e.link // max(int(coverage[cur[0]]), 1)
            ch = int_to_base[cur[2]]
            if not (int(coverage[cur[0]]) > min_cov and qv > lq_min_qv):
                ch = ch.lower()
            out.append((cur[0], ch, qv))
        cur = e.pp
    out.reverse()
    return out


def simulate(cols, coverage, length, read_type, min_cov=4):
    """Full pre-repair consensus; returns (bytes, [(pos, ch, qv)])."""
    msa = build_msa(cols)
    gb = run_dp(msa, coverage, length, read_type)
    if gb is None:
        return b"", []
    rows = traceback(msa, coverage, gb, min_cov=min_cov)
    seq = "".join(ch for _, ch, _ in rows).encode()
    return seq, rows


def main():
    import pickle

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from nextpolish_tpu.io.fasta import FastaIndex
    from nextpolish_tpu.models.cns.tags import (
        TagColumns, WindowAccum, read_columns, trim_read_columns)
    from nextpolish_tpu.models.cns.window import GAP_MIN_LEN, select_window_reads

    genome_fa = sys.argv[1]
    batch = pickle.load(open(sys.argv[2], "rb"))
    read_type = sys.argv[3] if len(sys.argv) > 3 else "ont"
    fa = FastaIndex(genome_fa)
    for name in fa.names:
        tid = batch.header.name2id(name)
        contig = np.frombuffer(fa.fetch(name).seq.upper(), np.uint8)
        L = len(contig)
        ridx = select_window_reads(batch, tid, 0, L, read_type)
        accum = WindowAccum(contig, 0, L, GAP_MIN_LEN[read_type])
        for r in ridx:
            tr = trim_read_columns(*read_columns(batch, int(r)),
                                   accum.ref_cns, 0, L)
            if tr is not None:
                accum.add_row(tr[0], tr[1], tr[2], int(r))
        merged = accum.finish()
        coverage = accum.coverage[:L]
        seq, rows = simulate(merged, coverage + 1, L, read_type)
        print(f"{name}: sim_len={len(seq)}")
        with open(f"/tmp/sim_{name}.pkl", "wb") as fh:
            pickle.dump((seq, rows), fh)


if __name__ == "__main__":
    main()
