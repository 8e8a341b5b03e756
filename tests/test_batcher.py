"""Cross-contig window batching + measurement-driven engine selection."""
import json
import threading

import numpy as np
import pytest

from test_cns import _make_batch, _noisy
from util_sim import rand_seq


def _sim_contig(rng, L):
    true = rand_seq(rng, L)
    draft = bytes(_noisy(rng, true, 0.01, 0.01, 0.01))
    batch, _ = _make_batch(rng, true, draft, n_reads=30, err=0.05)
    return draft, batch


def test_shared_batcher_matches_native(monkeypatch):
    """Contigs polished concurrently through ONE shared batcher (windows
    from different contigs grouped into the same launches) must equal the
    native engine run per contig."""
    from nextpolish_tpu.models.cns.batcher import CnsBatcher
    from nextpolish_tpu.models.ctg_cns import ctg_cns_contig
    from nextpolish_tpu.runtime.overlap import pipelined_map

    rng = np.random.default_rng(5)
    contigs = [_sim_contig(rng, L) for L in (4000, 2500, 3000, 2000)]

    monkeypatch.setenv("NPT_CNS_ENGINE", "native")
    want = [ctg_cns_contig(f"ctg", d, b, "ont") for d, b in contigs]

    monkeypatch.setenv("NPT_CNS_ENGINE", "device")
    bat = CnsBatcher("ont", max_batch=4)
    got = list(pipelined_map(
        lambda db: ctg_cns_contig("ctg", db[0], db[1], "ont", batcher=bat),
        contigs, depth=4))
    assert got == want
    assert bat.prepping == 0 and not bat.pending


def test_batcher_round_robins_devices(monkeypatch):
    """Window groups go to the batcher's devices in turn (one group per
    device here), and the result does not depend on where they ran."""
    import jax

    from nextpolish_tpu.models.cns.batcher import CnsBatcher
    from nextpolish_tpu.models.ctg_cns import ctg_cns_contig
    from nextpolish_tpu.runtime.overlap import pipelined_map

    devs = jax.devices()[:4]
    assert len(devs) == 4
    rng = np.random.default_rng(6)
    contigs = [_sim_contig(rng, 600) for _ in range(4)]

    monkeypatch.setenv("NPT_CNS_ENGINE", "native")
    want = [ctg_cns_contig("ctg", d, b, "ont") for d, b in contigs]

    monkeypatch.setenv("NPT_CNS_ENGINE", "device")
    bat = CnsBatcher("ont", max_batch=1, devices=devs)
    got = list(pipelined_map(
        lambda db: ctg_cns_contig("ctg", db[0], db[1], "ont", batcher=bat),
        contigs, depth=4))
    assert got == want
    assert [bat.launches[d] for d in devs] == [1, 1, 1, 1]


def test_batcher_partial_flush():
    """A single producer with fewer windows than a batch must not wait
    forever — partial groups flush when every producer is blocked."""
    from nextpolish_tpu.models.cns.batcher import CnsBatcher
    from nextpolish_tpu.models.cns.device_dp import prepare_window
    from nextpolish_tpu.models.cns.dp import link_dp

    rng = np.random.default_rng(8)
    draft, batch = _sim_contig(rng, 1500)
    from nextpolish_tpu.models.cns.window import window_prep

    ca = np.frombuffer(draft.upper(), dtype=np.uint8)
    work = window_prep(batch, 0, ca, 0, len(draft), "ont", None, "c")
    edges, dw = prepare_window(work.merged, work.coverage, work.L)
    assert dw is not None
    bat = CnsBatcher("ont", max_batch=8)
    with bat.contig():
        fut = bat.submit(dw)
    done = []
    t = threading.Thread(target=lambda: done.append(fut.result()))
    t.start()
    t.join(timeout=30)
    assert done and done[0] is not None
    score, best = done[0]
    s_ref, b_ref = link_dp(edges, work.coverage, "ont")
    assert np.array_equal(best, b_ref)


def test_engine_choice_is_measured(tmp_path, monkeypatch):
    """choose_engine picks the measured faster engine and caches it."""
    from nextpolish_tpu.models.cns import calib

    monkeypatch.setenv("NPT_CNS_CALIB", str(tmp_path / "calib.json"))
    monkeypatch.setattr(calib, "measure_engines",
                        lambda rt: {"native": 300e3, "device": 90e3})
    assert calib.choose_engine("ont") == "native"
    # cached decision survives a (mocked) flipped measurement
    monkeypatch.setattr(calib, "measure_engines",
                        lambda rt: {"native": 1.0, "device": 2.0})
    assert calib.choose_engine("ont") == "native"
    data = json.load(open(tmp_path / "calib.json"))
    (k,) = data.keys()
    assert data[k]["engine"] == "native"
    # a fresh cache re-measures
    monkeypatch.setenv("NPT_CNS_CALIB", str(tmp_path / "calib2.json"))
    assert calib.choose_engine("ont") == "device"


def test_probe_window_builds():
    """The synthetic probe window runs through both real engines and they
    agree (the probe is a real workload, not a toy)."""
    from nextpolish_tpu import native
    from nextpolish_tpu.models.cns import calib
    from nextpolish_tpu.models.cns.dp import link_dp, traceback
    from nextpolish_tpu.models.cns.msa import build_edges

    merged, coverage, L = calib._probe_window("ont")
    assert len(merged.t_pos) > 10 * L
    edges = build_edges(merged)
    score, best = link_dp(edges, coverage, "ont")
    cns = traceback(edges, score, best, coverage, L, "ont", 4, 20)
    assert len(cns.pos) > 0.9 * L
    if native.available():
        nat = native.cns_dp(merged.t_pos, merged.delta, merged.q_base,
                            merged.row_off, coverage, L, "ont", 4, 20)
        assert nat is not None
        assert np.array_equal(nat[0], cns.pos)
        assert np.array_equal(nat[1], cns.base)


def test_device_probe_failure_propagates(tmp_path, monkeypatch):
    """A device scan that raises during the probe fails choose_engine: the
    engine choice never silently degrades to the host engine."""
    from nextpolish_tpu.models.cns import calib
    from nextpolish_tpu.models.cns import device_dp as dd

    monkeypatch.setenv("NPT_CNS_CALIB", str(tmp_path / "calib.json"))
    monkeypatch.setattr(calib, "PROBE_LEN", 3000)

    def broken(*a, **k):
        raise RuntimeError("device launch failed")

    monkeypatch.setattr(dd, "_run_batch", broken)
    with pytest.raises(RuntimeError, match="device launch failed"):
        calib.choose_engine("ont")
    assert not (tmp_path / "calib.json").exists()
