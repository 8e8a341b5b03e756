"""Full-pipeline byte-equality against the reference NextPolish (north star).

Runs the REAL reference pipeline (`nextPolish run.cfg`, /tmp/refbuild with
its own bwa/samtools/minimap2 and engines, local paralleltask shim) on the
bundled test_data, then drives OUR engines on the reference-produced BAMs of
every round and asserts byte-identical output at each stage and for the
final FASTA.

Note on the bundled `genome.nextpolish.fa`: the reference source in this
tree does NOT reproduce that file (it emits `_np12`-suffixed names and
slightly different bases — the bundled file predates the v1.4.1-era code).
The reference run itself is deterministic (verified by back-to-back runs),
so the live oracle is what the reference *code* produces, and that is what
we match byte-for-byte.
"""
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

REFBUILD = "/tmp/refbuild"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def refpipe(tmp_path_factory):
    from run_reference_pipeline import TEST_DATA, run

    if not os.path.isdir(TEST_DATA):
        pytest.skip("reference source tree (and its test_data) absent")
    if not (os.path.exists(os.path.join(REFBUILD, "lib", "nextpolish2.so"))
            and os.path.exists(os.path.join(REFBUILD, "bin", "bwa"))):
        # build_ref_oracle.sh is idempotent: it fills in whatever of the
        # engines and pipeline bits (bin/, seq_split, calgs.so) is missing
        try:
            subprocess.run(
                ["bash", os.path.join(REPO, "tools", "build_ref_oracle.sh")],
                check=True, capture_output=True)
        except subprocess.CalledProcessError:
            pytest.skip("reference oracle could not be built")

    wd = str(tmp_path_factory.mktemp("refpipe"))
    run(wd, REFBUILD)
    return os.path.join(wd, "rundir")


def _fa(path):
    from nextpolish_tpu.io.fasta import read_fastx

    return [(r.name, r.seq) for r in read_fastx(path)]


def test_full_pipeline_byte_equality(refpipe):
    from nextpolish_tpu.io.bam import read_bam
    from nextpolish_tpu.models.ctg_cns import ctg_cns_contig
    from nextpolish_tpu.models.kmer_count import kmer_count_contig
    from nextpolish_tpu.models.score_chain import (
        AlgoConfig,
        estimate_read_tlen,
        score_chain_contig,
    )

    # ---- stage 00.lgs_polish (task 5, ONT ctg_cns) --------------------
    batch = read_bam(os.path.join(refpipe, "00.lgs_polish", "lgs.sort.bam"))
    genome = _fa(os.path.join(refpipe, "00.lgs_polish", "input.genome.fasta"))
    expected = dict(_fa(os.path.join(refpipe, "01.score_chain",
                                     "input.genome.fasta")))
    ours = {}
    for name, seq in genome:
        for pname, pseq in ctg_cns_contig(name, seq, batch, "ont", split=0,
                                          window=5_000_000):
            ours[pname] = pseq
    assert set(ours) == set(expected)
    for name in expected:
        assert ours[name] == expected[name], f"task 5 diverges on {name}"

    # ---- stage 01.score_chain (task 1) --------------------------------
    batch = read_bam(os.path.join(refpipe, "01.score_chain", "sgs.sort.bam"))
    genome = _fa(os.path.join(refpipe, "01.score_chain",
                              "input.genome.fasta"))
    expected = dict(_fa(os.path.join(refpipe, "02.kmer_count",
                                     "input.genome.fasta")))
    cfg = AlgoConfig()
    cfg.read_tlen = estimate_read_tlen(batch, cfg)
    for name, seq in genome:
        out = score_chain_contig(name, seq, batch, cfg)
        assert expected[name + "_np1"] == out, f"task 1 diverges on {name}"

    # ---- stage 02.kmer_count (task 2) ---------------------------------
    batch = read_bam(os.path.join(refpipe, "02.kmer_count", "sgs.sort.bam"))
    genome = _fa(os.path.join(refpipe, "02.kmer_count",
                              "input.genome.fasta"))
    final = os.path.join(refpipe, "genome.nextpolish.fasta")
    expected = dict(_fa(final))
    cfg = AlgoConfig()
    cfg.read_tlen = estimate_read_tlen(batch, cfg)
    ours = {}
    for name, seq in genome:
        out = kmer_count_contig(name, seq, batch, cfg)
        ours[name + "2"] = out
        assert expected[name + "2"] == out, f"task 2 diverges on {name}"

    # ---- final FASTA: byte-for-byte -----------------------------------
    rebuilt = b"".join(
        b">%s %d\n%s\n" % (n.encode(), len(ours[n]), ours[n])
        for n, _ in _fa(final))
    assert rebuilt == open(final, "rb").read()
