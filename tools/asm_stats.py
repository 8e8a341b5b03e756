"""Assembly accuracy vs an expected FASTA: map the query contigs with the
built-in long-read mapper and count mismatches / indel bases from the CIGAR
(the role of the quast checks in the reference's doc/TEST*.rst protocols).

Usage: python tools/asm_stats.py <query.fa> <target.fa>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

NIB_TO_ASCII = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)


def asm_stats(query_fa: str, target_fa: str, sites: bool = False):
    """(mismatches, indel_bases, aligned_bases) of query vs target.
    With sites=True also returns the divergent-site list
    [(target_name, target_pos, kind, detail)] for attribution."""
    from nextpolish_tpu.align.index import GenomeIndex
    from nextpolish_tpu.align.longread import map_long_batch
    from nextpolish_tpu.io.bam import FSUPPLEMENTARY, FUNMAP
    from nextpolish_tpu.io.fasta import read_fastx

    tgt = {r.name: r.seq.upper() for r in read_fastx(target_fa)}
    qry = [(r.name, r.seq.upper()) for r in read_fastx(query_fa)]
    idx = GenomeIndex.build(list(tgt.items()), k=15, w=5)
    recs = map_long_batch(idx, [s for _, s in qry], [n for n, _ in qry])
    mm = ind = aligned = 0
    site_list = []
    for rec in recs:
        if rec is None or (rec["flag"] & (FSUPPLEMENTARY | FUNMAP)):
            continue
        tname = idx.names[rec["tid"]]
        ref = tgt[tname]
        q = NIB_TO_ASCII[rec["seq_nib"]]
        r = np.frombuffer(ref, dtype=np.uint8)
        qi, rj = 0, rec["pos"]
        for cw in rec["cigar"]:
            op, ln = int(cw) & 0xF, int(cw) >> 4
            if op == 0:  # M
                neq = q[qi : qi + ln] != r[rj : rj + ln]
                mm += int(neq.sum())
                if sites:
                    for o in np.flatnonzero(neq):
                        site_list.append((tname, rj + int(o), "mm",
                                          f"{chr(r[rj + o])}->"
                                          f"{chr(q[qi + o])}"))
                aligned += ln
                qi += ln
                rj += ln
            elif op == 1:  # I
                ind += ln
                if sites:
                    site_list.append((tname, rj, "ins",
                                      q[qi:qi + ln].tobytes().decode()))
                qi += ln
            elif op == 2:  # D
                ind += ln
                if sites:
                    site_list.append((tname, rj, "del",
                                      r[rj:rj + ln].tobytes().decode()))
                rj += ln
            elif op == 4:  # S
                qi += ln
    if sites:
        return mm, ind, aligned, site_list
    return mm, ind, aligned


def main(query_fa: str, target_fa: str, show_sites: bool = False):
    if show_sites:
        mm, ind, aligned, sites = asm_stats(query_fa, target_fa, sites=True)
        for name, pos, kind, detail in sites:
            print(f"{name}\t{pos}\t{kind}\t{detail}")
    else:
        mm, ind, aligned = asm_stats(query_fa, target_fa)
    print(f"mismatches={mm} indel_bases={ind} aligned={aligned}")
    return mm, ind


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], "--sites" in sys.argv[3:])
