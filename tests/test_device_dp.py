"""Device engine-2 link DP (kernel and plain scan) vs the host paths.

The device scan in models/cns/device_dp.py must reproduce the numpy
EdgeTable DP (itself byte-parity-tested against the reference .so) bit for
bit: same winning entries, same selected scores, same consensus
(incl. lowercase qv marking), for every read type's tie rules.
"""
import numpy as np
import pytest

from nextpolish_tpu.models.cns.device_dp import (
    densify_window,
    device_link_dp,
)
from nextpolish_tpu.models.cns.dp import link_dp, traceback
from nextpolish_tpu.models.cns.msa import build_edges
from nextpolish_tpu.models.cns.tags import (
    WindowAccum,
    read_columns,
    trim_read_columns,
)
from nextpolish_tpu.ops.pileup import region_overlap_mask
from util_sim import rand_seq

from test_cns import _make_batch, _noisy


@pytest.fixture(scope="module")
def ont_window():
    rng = np.random.default_rng(7)
    true = rand_seq(rng, 9000)
    # draft with errors so the DP has real work
    draft = bytes(_noisy(rng, true, 0.01, 0.01, 0.01))
    batch, _ = _make_batch(rng, true, draft, n_reads=60, err=0.04)
    tid = 0
    L = len(draft)
    contig_ascii = np.frombuffer(draft.upper(), dtype=np.uint8)
    accum = WindowAccum(contig_ascii, 0, L, 3)
    ridx = np.flatnonzero(region_overlap_mask(batch, tid, 0, L - 1))
    for r in ridx:
        r = int(r)
        if int(batch.flag[r]) & 0xD04:
            continue
        tr = trim_read_columns(*read_columns(batch, r), accum.ref_cns,
                               0, L)
        if tr is None:
            continue
        accum.add_row(tr[0], tr[1], tr[2], r)
    merged = accum.finish()
    coverage = accum.coverage[:L] + 1
    return build_edges(merged), coverage, L


@pytest.mark.parametrize("rt", ["ont", "clr", "rs", "hifi"])
def test_device_dp_matches_numpy(ont_window, rt):
    edges, coverage, L = ont_window
    score_np, best_np = link_dp(edges, coverage, rt)
    dw = densify_window(edges, coverage, L)
    assert dw is not None, "window should fit the device caps"
    score_dev, best_dev = device_link_dp(dw, rt)
    assert np.array_equal(best_np, best_dev)
    assert np.array_equal(score_np[best_np], score_dev[best_dev])
    cns_np = traceback(edges, score_np, best_np, coverage, L, rt, 4, 20)
    cns_dev = traceback(edges, score_dev, best_dev, coverage, L, rt, 4, 20)
    assert np.array_equal(cns_np.pos, cns_dev.pos)
    assert np.array_equal(cns_np.base, cns_dev.base)
    assert np.array_equal(cns_np.qv, cns_dev.qv)


def test_device_engine_end_to_end(monkeypatch):
    """window_consensus with NPT_CNS_ENGINE=device equals the default
    native engine through LQ repair and stitching."""
    from nextpolish_tpu.models.ctg_cns import ctg_cns_contig

    rng = np.random.default_rng(11)
    true = rand_seq(rng, 12000)
    draft = bytes(_noisy(rng, true, 0.01, 0.01, 0.01))
    batch, _ = _make_batch(rng, true, draft, n_reads=50, err=0.05)
    outs = {}
    for eng in ("native", "device"):
        monkeypatch.setenv("NPT_CNS_ENGINE", eng)
        outs[eng] = ctg_cns_contig("ctg", draft, batch, "ont")
    assert outs["native"] == outs["device"]
    assert len(outs["device"][0][1]) > 10000


def test_device_dp_deep_insertion_chain():
    """A read with a giant insertion (delta in the hundreds) is just more
    levels for the device scan — no fallback, same answer."""
    from nextpolish_tpu.align.index import GenomeIndex
    from nextpolish_tpu.align.longread import map_long_batch
    from nextpolish_tpu.align.mapper import records_to_batch

    rng = np.random.default_rng(3)
    true = rand_seq(rng, 4000)
    draft = true
    idx = GenomeIndex.build([("ctg", draft)], k=15, w=10)
    reads = []
    for i in range(12):
        r = bytearray(_noisy(rng, true, 0.02, 0.02, 0.02))
        if i == 0:
            # 300 bp insertion mid-read
            r[1800:1800] = rand_seq(rng, 300)
        reads.append(bytes(r))
    batch = records_to_batch(map_long_batch(idx, reads), idx)
    L = len(draft)
    contig_ascii = np.frombuffer(draft, dtype=np.uint8)
    accum = WindowAccum(contig_ascii, 0, L, 3)
    for r in np.flatnonzero(region_overlap_mask(batch, 0, 0, L - 1)):
        r = int(r)
        if int(batch.flag[r]) & 0xD04:
            continue
        tr = trim_read_columns(*read_columns(batch, r), accum.ref_cns,
                               0, L)
        if tr is None:
            continue
        accum.add_row(tr[0], tr[1], tr[2], r)
    merged = accum.finish()
    deltas = merged.delta
    assert deltas.max() >= 200, "sim should have produced a deep chain"
    coverage = accum.coverage[:L] + 1
    edges = build_edges(merged)
    dw = densify_window(edges, coverage, L)
    assert dw is not None
    score_np, best_np = link_dp(edges, coverage, "ont")
    score_dev, best_dev = device_link_dp(dw, "ont")
    assert np.array_equal(best_np, best_dev)


@pytest.mark.parametrize("rt", ["ont", "clr", "rs"])
def test_pallas_batched_windows_match(rt):
    """Several windows of different lengths in ONE kernel launch (B>1, one
    program per window; interpret mode on CPU) must each equal the
    lax.scan result bit for bit."""
    from nextpolish_tpu.models.cns import device_dp as dd

    rng = np.random.default_rng(19)
    dws = []
    for Lt_ in (1500, 3000, 800):
        true = rand_seq(rng, Lt_)
        draft = bytes(_noisy(rng, true, 0.01, 0.01, 0.01))
        batch, _ = _make_batch(rng, true, draft, n_reads=30, err=0.05)
        L = len(draft)
        contig_ascii = np.frombuffer(draft.upper(), dtype=np.uint8)
        accum = WindowAccum(contig_ascii, 0, L, 3)
        for r in np.flatnonzero(region_overlap_mask(batch, 0, 0, L - 1)):
            r = int(r)
            if int(batch.flag[r]) & 0xD04:
                continue
            tr = trim_read_columns(*read_columns(batch, r),
                                   accum.ref_cns, 0, L)
            if tr is not None:
                accum.add_row(tr[0], tr[1], tr[2], r)
        merged = accum.finish()
        coverage = accum.coverage[:L] + 1
        edges = build_edges(merged)
        dw = densify_window(edges, coverage, L)
        assert dw is not None
        dws.append(dw)
    refs = [dd._run_batch([dw], rt, kernel=False)[0] for dw in dws]
    pals = dd._run_batch(dws, rt, kernel=True)
    assert len(pals) == len(dws)
    for ref, pal in zip(refs, pals):
        assert np.array_equal(ref[0], pal[0])
        assert np.array_equal(ref[1], pal[1])


@pytest.mark.parametrize("rt", ["ont", "clr", "rs", "hifi"])
def test_pallas_scan_matches_lax_scan(ont_window, rt):
    """The level-scan kernel (interpret mode on CPU) must equal the
    chunked lax.scan path bit for bit, in the wide (E, Vb) bucket too."""
    from nextpolish_tpu.models.cns import device_dp as dd

    edges, coverage, L = ont_window
    dw = densify_window(edges, coverage, L)
    assert dw is not None
    (ref,) = dd._run_batch([dw], rt, kernel=False)
    wide = dict(E=dd.E_BUCKETS[-1], Vb=dd.VB_BUCKETS[-1])
    for kw in ({}, wide):
        (pal,) = dd._run_batch([dw], rt, kernel=True, **kw)
        assert np.array_equal(ref[0], pal[0])
        assert np.array_equal(ref[1], pal[1])


@pytest.mark.parametrize("platform,kernel", [("gpu", True), ("cpu", False)])
def test_scan_route_follows_backend(monkeypatch, platform, kernel):
    """The GPU backend takes the Triton kernel, the CPU backend the plain
    lax.scan."""
    import jax

    from nextpolish_tpu.models.cns import device_dp as dd

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert dd._use_kernel() is kernel


def test_scan_route_unknown_platform_raises(monkeypatch):
    """Any platform without a route is an error, not a fallback: both the
    backend choice and the kernel builder refuse it."""
    import jax

    from nextpolish_tpu.models.cns import device_dp as dd
    from nextpolish_tpu.models.cns.pallas_scan import level_scan_call

    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported platform"):
        dd._use_kernel()
    with pytest.raises(RuntimeError, match="no route"):
        level_scan_call(16, 8, 0, 3, 1, 8, "rocm")


def test_pack_group_buckets_and_padding(ont_window):
    """pack_group picks the smallest (E, Vb) bucket that fits, pads the
    batch to a power of two with empty windows, and re-bases
    same-position predecessor indices past a wider ring."""
    from nextpolish_tpu.models.cns import device_dp as dd

    edges, coverage, L = ont_window
    dw = densify_window(edges, coverage, L)
    pk = dd.pack_group([dw] * 3)
    assert pk.lvl.shape[0] == 4 and pk.nlev.tolist()[3] == 0
    assert pk.E == min(e for e in dd.E_BUCKETS if e >= dw.E)
    assert pk.NCL >= dw.n_levels and pk.NCL % dd.LEVELS_PER_STEP == 0
    assert (pk.meta[0, dw.n_levels:] & 1).all()  # pad levels flagged
    wide = dd.pack_group([dw], Vb=24)
    assert wide.Vb == 24
    shift = (wide.A[0, :len(dw.ent_b)] - pk.A[0, :len(dw.ent_b)]) >> 8
    assert (shift[dw.ent_same] == (24 - pk.Vb) * 6).all()
    assert (shift[~dw.ent_same] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("rt", ["ont", "clr", "rs", "hifi"])
def test_level_scan_kernel_on_gpu(ont_window, rt, gpu):
    """The Triton-compiled kernel (two windows in one launch) equals the
    host numpy DP on the GPU."""
    from nextpolish_tpu.models.cns import device_dp as dd

    edges, coverage, L = ont_window
    score_np, best_np = link_dp(edges, coverage, rt)
    dw = densify_window(edges, coverage, L)
    for best, sc in dd._run_batch([dw] * 2, rt, kernel=True):
        score_dev, best_dev = dd._to_edge_outputs(dw, best, sc)
        assert np.array_equal(best_np, best_dev)
        assert np.array_equal(score_np[best_np], score_dev[best_dev])
