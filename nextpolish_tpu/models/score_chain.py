"""Task 1 — short-read score-chain correction (lib/scorechain.c:3-15).

Pipeline per contig:
  read filter level (contig_read_fliter1) -> insert-slot discovery -> dense
  pileup counts -> tropical chain scan on device -> corrected bases + flags
  -> FASTA emission with FLAG_ZERO|FLAG_COVERAGE lowercasing.

Also provides `score_correct_region`, the shared regional correction used by
the kmer_count no-depth rescue (contig_score_correct, lib/contig.c:706-734)
and the long-read chain variant (td_score_chain1, lib/scorechain.c:17-29).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

from ..io.bam import AlnBatch
from ..io.fasta import ASCII_TO_NIB
from ..ops import pileup as pl
from ..ops.symbols import K3, S
from ..ops.tropical import chain_correct, init_state, pad_to_chunk
from .contig_state import (ContigState, find_regions, maybe_trace,
                           merge_regions)
from .flags import FLAG_COVERAGE, FLAG_ZERO


@dataclass
class AlgoConfig:
    """Algorithm thresholds (C Configure defaults, lib/config.c:10-41)."""

    trim_len_edge: int = 2
    ext_len_edge: int = 2
    min_map_quality: int = 0
    indel_balance_factor_sgs: float = 0.5
    min_count_ratio_skip: float = 0.8
    min_len_ldr: int = 3
    min_len_inter_kmer: int = 5
    max_len_kmer: int = 50
    max_count_kmer: int = 50
    indel_balance_factor_lgs: float = 0.33
    max_clip_ratio_sgs: float = 0.15
    max_clip_ratio_lgs: float = 0.4
    max_ins_len_sgs: int = 10000
    max_ins_fold_sgs: int = 5
    count_read_ins_sgs: int = 10000
    min_depth_snp: int = 3
    min_count_snp: int = 5
    min_count_snp_link: int = 5
    ploidy: float = 2.0
    max_indel_factor_lgs: float = 0.21
    max_snp_factor_lgs: float = 0.53
    min_snp_factor_sgs: float = 0.34
    max_variant_count_lgs: int = 150000
    read_tlen: int = 0  # estimated insert size * max_ins_fold_sgs
    read_len: int = 0  # first read's length (Configure.read_len)
    # -debug (trace_polish_open, lib/config.c:40): when a list, engines
    # append (name, pos, index, curbase, draftbase) per changed base
    trace_sink: list | None = None


def estimate_read_tlen(batch: AlnBatch, cfg: AlgoConfig) -> int:
    """Mean insert size from the first ~10k proper pairs * max_ins_fold_sgs
    (bam_tlen, lib/config.c:80-101 — including its count-from-1 average)."""
    tl = batch.tlen
    sel = (tl > 0) & (tl < cfg.max_ins_len_sgs)
    take = np.flatnonzero(sel)[: cfg.count_read_ins_sgs - 1]
    count = len(take) + 1
    mean = int(tl[take].sum()) // count
    if len(batch):
        cfg.read_len = int(batch.lqseq[0])
    return mean * cfg.max_ins_fold_sgs


def _coverage_of(counts: np.ndarray, choice: np.ndarray) -> np.ndarray:
    """Per-cell count supporting the chosen base (base_get_coverage,
    lib/base.c:79-89) — sum of the chosen suffix lane only (gathering the
    lane first avoids reducing all S lanes of the big counts tensor)."""
    n = len(choice)
    lane = counts.reshape(n, S * S, S)[np.arange(n), :, choice.astype(np.int64)]
    return lane.sum(axis=1, dtype=np.int64)


def run_chain_region(counts: np.ndarray, refkmer: np.ndarray,
                     total: np.ndarray, n_dp: int, rate: float,
                     rank: np.ndarray | None = None) -> np.ndarray:
    from ..ops.tropical import run_chain

    return run_chain(counts, refkmer, total, n_dp, rate, rank=rank)


def score_correct_region(state: ContigState, batch: AlnBatch,
                         levels: np.ndarray, tid: int,
                         contig_nib: np.ndarray, start: int, end: int,
                         filterlevel: int, rate: float, cfg: AlgoConfig
                         ) -> None:
    """contig_score_correct (lib/contig.c:706-734) on [start, end], assuming
    insert slots already exist in state.index.  Mutates state in place."""
    view = state.index.region_view(start, end)
    cell0 = int(state.index.cell_of[start - state.index.start])
    p = pl.build_pileup_sparse(batch, levels, filterlevel, view, tid,
                               contig_nib, cfg.trim_len_edge)
    _apply_correction_sparse(state, p, cell0, rate, cfg)

    if filterlevel == 2:
        # no-depth rescue: re-parse FLAG_ZERO runs at filter level 1
        # (lib/contig.c:721-733); all regions run in one batched launch
        nodepth = find_regions(state, start, end, gap=0, con=0,
                               flag_bit=FLAG_ZERO, extend=False,
                               ext_len_edge=cfg.ext_len_edge)
        problems = []
        metas = []
        for rs, re in merge_regions(nodepth):
            sub = state.index.region_view(rs, re)
            sub_cell0 = int(state.index.cell_of[rs - state.index.start])
            lo = sub_cell0 - cell0
            hi = lo + sub.n_cells_dp
            ex = pl.expand_reads(batch, levels, 1, sub, tid,
                                 cfg.trim_len_edge)
            extra = pl.sparse_counts(ex.cells, ex.kmers(), sub.n_cells)
            counts = np.minimum(
                p.dense_window(lo, hi).astype(np.int32)
                + extra[: sub.n_cells_dp], 0xFFFF
            ).astype(np.uint16)
            total = p.total[lo:hi] + np.bincount(
                ex.cells, minlength=sub.n_cells
            )[: sub.n_cells_dp].astype(np.int32)
            # ranks: the level-2 parse's data lists persist; level-1 kmers
            # append after them (lib/contig.c:721-733, no base_clean_data)
            rank = pl.event_ranks(
                ex.cells[ex.cells < sub.n_cells_dp],
                ex.kmers()[ex.cells < sub.n_cells_dp].astype(np.int64),
                sub.n_cells_dp, base_ndistinct=p.ndistinct(lo, hi),
                base_rank=p.rank_window(lo, hi))
            problems.append((counts, p.refkmer[lo:hi], total, rank))
            metas.append((sub, sub_cell0, counts, total))
        from ..ops.tropical import run_chain_batch

        for choice, (sub, sub_cell0, counts, total) in zip(
                run_chain_batch(problems, rate), metas):
            _apply_choice(state, sub.n_cells_dp, choice, counts, total,
                          sub_cell0, cfg)


def _apply_correction_sparse(state: ContigState, p, cell0: int, rate: float,
                             cfg: AlgoConfig) -> None:
    from ..ops.tropical import dispatch_chain_sparse

    n_dp = p.index.n_cells_dp
    dev = dispatch_chain_sparse(p.uk, p.cn, p.rk, p.refkmer, p.total, n_dp,
                                rate, cov_ratio=cfg.min_count_ratio_skip)
    _finish_correction_sparse(state, p, cell0, dev, cfg)


def _finish_correction_sparse(state: ContigState, p, cell0: int, dev,
                              cfg: AlgoConfig) -> None:
    """Unpack the device result byte: choice in bits 0-2, FLAG_ZERO /
    FLAG_COVERAGE decisions in bits 3-4 (computed on device with the exact
    integer-threshold equivalent of the host's f64 compares)."""
    from ..ops.tropical import FLAGB_COV, FLAGB_ZERO

    n_dp = p.index.n_cells_dp
    packed = np.asarray(dev)[:n_dp]
    cells = cell0 + np.arange(n_dp)
    state.base[cells] = packed & 7
    state.update_flags(cells, (packed >> FLAGB_ZERO) & 1 == 1, FLAG_ZERO)
    state.update_flags(cells, (packed >> FLAGB_COV) & 1 == 1, FLAG_COVERAGE)


def _apply_choice(state: ContigState, n_dp: int, choice: np.ndarray,
                  counts: np.ndarray, total_arr: np.ndarray, cell0: int,
                  cfg: AlgoConfig) -> None:
    cells = cell0 + np.arange(n_dp)
    state.base[cells] = choice[:n_dp]
    total = total_arr[:n_dp].astype(np.int64)
    state.update_flags(cells, total == 1, FLAG_ZERO)
    cov = _coverage_of(counts[:n_dp], choice[:n_dp])
    low = cov < cfg.min_count_ratio_skip * np.maximum(total, 1)
    state.update_flags(cells, low, FLAG_COVERAGE)


def _apply_correction(state: ContigState, p: pl.Pileup, cell0: int,
                      rate: float, cfg: AlgoConfig) -> None:
    """Chain DP + base/flag update (contig_region_score + _region_correct)."""
    n_dp = p.index.n_cells_dp
    choice = run_chain_region(p.counts, p.refkmer, p.total, n_dp, rate,
                              rank=p.rank)
    _apply_choice(state, n_dp, choice, p.counts, p.total, cell0, cfg)


class _ChainHandle:
    """One contig staged between host prep and DP finish."""

    __slots__ = ("name", "state", "p", "cell0", "cfg", "draft", "buf",
                 "key", "dev", "lane", "holder")

    def __init__(self, name, state, p, cell0, cfg, draft, buf, key):
        self.name = name
        self.state = state
        self.p = p
        self.cell0 = cell0
        self.cfg = cfg
        self.draft = draft
        self.buf = buf
        self.key = key  # jit shape bucket: ("planes", L, Emax, EOV, ET, FMT, TH, PS)
        #               or ("entries", L, E, TH)
        self.dev = None  # device result (set at dispatch)
        self.lane = None  # row in a batched launch
        self.holder = None  # shared fetch memo for the batch

    @property
    def L(self):
        return self.key[1]


def score_chain_contig_prep(name: str, draft: bytes, batch: AlnBatch,
                            cfg: AlgoConfig, levels=None) -> _ChainHandle:
    """Host half of task 1 for one contig: pileup walk + packed DP
    buffer, NO device dispatch — the pipeline batches several contigs'
    buffers into one launch (the slot-plane kernel has no big scatters
    and lanes ride the scan nearly free; see
    tropical.chain_correct_planes_batch)."""
    import os as _os
    from types import SimpleNamespace

    from ..ops.tropical import (
        pack_chain_planes,
        pack_chain_planes_parts,
        pack_chain_sparse,
    )

    tid = batch.header.name2id(name)
    L = len(draft)
    if levels is None:
        levels = pl.filter_sgs_chain(batch)
    index = pl.build_cell_index(batch, levels, tid, 0, L - 1)
    state = ContigState.from_draft(name, draft, index)
    contig_nib = ASCII_TO_NIB[np.frombuffer(draft, dtype=np.uint8)]
    view = state.index.region_view(0, L - 1)
    cell0 = int(state.index.cell_of[0 - state.index.start])
    impl = _os.environ.get("NPT_CHAIN_IMPL", "")
    if impl not in ("entries", "pyplanes"):
        # hot path: the native slot walker emits the transfer planes
        # directly (byte-equal to the fallback below by test)
        # the pipeline runs two prep threads on its own; each walker
        # then takes ONE thread so 2 cores aren't oversubscribed
        wt = int(_os.environ.get("NPT_PILEUP_THREADS", "0"))
        fast = pl.build_pileup_planes(batch, levels, 1, view, tid,
                                      contig_nib, cfg.trim_len_edge,
                                      n_threads=wt)
        if fast is not None:
            upper, c0, totals, stats, ov, refkmer = fast
            buf, *shape = pack_chain_planes_parts(
                upper, c0, totals, stats, ov, refkmer, view.n_cells_dp,
                cfg.indel_balance_factor_sgs,
                cov_ratio=cfg.min_count_ratio_skip)
            key = ("planes", *shape)
            p = SimpleNamespace(index=view)
            return _ChainHandle(name, state, p, cell0, cfg, draft, buf,
                                key)
    p = pl.build_pileup_sparse(batch, levels, 1, view, tid, contig_nib,
                               cfg.trim_len_edge)
    if impl == "entries":
        buf, Lp, E, TH = pack_chain_sparse(
            p.uk, p.cn, p.rk, p.refkmer, p.total, p.index.n_cells_dp,
            cfg.indel_balance_factor_sgs,
            cov_ratio=cfg.min_count_ratio_skip)
        key = ("entries", Lp, E, TH)
    else:
        buf, *shape = pack_chain_planes(
            p.uk, p.cn, p.rk, p.refkmer, p.total, p.index.n_cells_dp,
            cfg.indel_balance_factor_sgs,
            cov_ratio=cfg.min_count_ratio_skip)
        key = ("planes", *shape)
    return _ChainHandle(name, state, p, cell0, cfg, draft, buf, key)


def dispatch_chain_group(handles: list, device=None) -> None:
    """Launch one (batched) chain DP for handles sharing a shape-bucket
    key; results start streaming to the host immediately."""
    import jax

    from ..ops.tropical import (
        chain_correct_packed,
        chain_correct_packed_batch,
        chain_correct_planes,
        chain_correct_planes_batch,
        start_host_copy,
    )
    from ..runtime import trace

    h0 = handles[0]
    kind, shape = h0.key[0], h0.key[1:]
    single = (chain_correct_planes if kind == "planes"
              else chain_correct_packed)
    batched = (chain_correct_planes_batch if kind == "planes"
               else chain_correct_packed_batch)
    if len(handles) == 1:
        buf = h0.buf if device is None else jax.device_put(h0.buf, device)
        h0.dev = single(buf, *shape)
        start_host_copy(h0.dev)
    else:
        bufs = np.stack([h.buf for h in handles])
        if device is not None:
            bufs = jax.device_put(bufs, device)
        dev = batched(bufs, *shape)
        holder = {"dev": dev, "np": None}
        for i, h in enumerate(handles):
            h.holder = holder
            h.lane = i
        start_host_copy(dev)
    for h in handles:  # the pack buffer is device-side now; don't let
        h.buf = None   # pending handles hold its host copy alive
    trace.count("task1.chain_cells", h0.L * len(handles))
    trace.count("task1.chain_launches", 1)


def score_chain_contig_begin(name: str, draft: bytes, batch: AlnBatch,
                             cfg: AlgoConfig, levels=None, device=None):
    """Prep + immediate single-contig dispatch (compat entry; the
    pipeline preps and batches instead)."""
    h = score_chain_contig_prep(name, draft, batch, cfg, levels=levels)
    dispatch_chain_group([h], device=device)
    return h


def score_chain_contig_end(handle) -> bytes:
    """Pipelined task-1 entry, stage 2: fetch the DP result, apply flags,
    emit the polished sequence."""
    from ..runtime import trace

    h = handle
    done = getattr(h, "done", None)
    if done is not None:  # windowed big-contig path finished in prep
        return done
    with trace.timed("task1.wait"):
        if h.lane is None:
            packed = np.asarray(h.dev)
        else:
            if h.holder["np"] is None:
                h.holder["np"] = np.asarray(h.holder["dev"])
            packed = h.holder["np"][h.lane]
    with trace.timed("task1.host"):
        _finish_correction_sparse(h.state, h.p, h.cell0, packed, h.cfg)
        maybe_trace(h.cfg, h.state.name, h.state, h.draft)
        return h.state.emit(FLAG_ZERO | FLAG_COVERAGE)


def score_chain_contig(name: str, draft: bytes, batch: AlnBatch,
                       cfg: AlgoConfig) -> bytes:
    """Task 1 entry for one contig: polished sequence bytes
    (score_chain, lib/scorechain.c:3-15)."""
    return score_chain_contig_end(
        score_chain_contig_begin(name, draft, batch, cfg))


def score_chain_pipeline(names_seqs, batch, cfg: AlgoConfig, devices=None):
    """Software-pipelined task 1 over contigs (the device analog of the
    reference's multiprocessing Pool over contigs, lib/nextpolish1.py:223-224).
    Three overlapped stages per contig:

      prep (worker thread): BAM fetch + cell index + native pileup walk +
            DP buffer packing — the ctypes call releases the GIL, so it
            runs concurrently with the main thread;
      device: contigs sharing an (L, E, TH) shape bucket BATCH into one
            chain launch (NPT_CHAIN_BATCH contigs per launch); results
            start streaming to the host immediately (start_host_copy);
      finish (main thread): flags + FASTA emission.

    Yields (name, polished bytes) in order.  `batch` may be a region source
    (anything with .fetch / .header, e.g. io.bamregion.IndexedBam): each
    contig's reads are then fetched on demand, so peak RAM is one contig,
    not the whole BAM.  `devices` (default runtime.devices.compute_devices)
    are the devices contig groups round-robin over."""
    from concurrent.futures import ThreadPoolExecutor

    streaming = hasattr(batch, "fetch")
    shared_levels = None if streaming else pl.filter_sgs_chain(batch)
    # contig-level device parallelism: round-robin contig GROUPS over
    # the local devices (runtime.devices)
    import os as _os

    from ..runtime.devices import compute_devices

    devices = devices or compute_devices()
    G = max(1, int(_os.environ.get("NPT_CHAIN_BATCH", "1")))
    n_grp = itertools.count()  # next() is atomic: prep threads share it

    from ..runtime import trace

    # single-launch cells are capped: contigs above
    # NPT_CHAIN_WINDOW_BASES run through the windowed sharded-chain path
    # on a single-device mesh — 2^17-cell windows with byte-exact s0
    # chaining and backward stitch (score_chain_contig_sharded).  Both
    # sizes are byte-exact at any value and not yet tuned for the GPU's
    # memory (ROADMAP B3).
    win_bases = int(_os.environ.get("NPT_CHAIN_WINDOW_BASES", "1000000"))
    _mesh1 = []

    def prep(name, seq):
        with trace.timed("task1.host"):
            if streaming:
                tid = batch.header.name2id(name)
                cbatch = batch.fetch(tid, 0, max(len(seq) - 1, 0))
                clevels = pl.filter_sgs_chain(cbatch)
            else:
                cbatch, clevels = batch, shared_levels
            if len(seq) > win_bases:
                from types import SimpleNamespace

                from ..parallel.shard import reads_mesh

                if not _mesh1:
                    _mesh1.append(reads_mesh(1))
                # 2^17-cell windows bound the merge kernel's dense
                # [Wc*K3] scratch tensors (untuned for the GPU, B3)
                out = score_chain_contig_sharded(name, seq, cbatch, cfg,
                                                 _mesh1[0],
                                                 levels=clevels,
                                                 window_cells=1 << 17)
                return SimpleNamespace(done=out)
            h = score_chain_contig_prep(name, seq, cbatch, cfg,
                                        levels=clevels)
            if G == 1:
                # unbatched: dispatch straight from the prep thread so
                # the DP launch overlaps the main thread maximally (the
                # G>1 trade-off is untuned for the GPU, ROADMAP A5)
                dev = (devices[next(n_grp) % len(devices)]
                       if len(devices) > 1 else None)
                dispatch_chain_group([h], device=dev)
            return h

    staged: dict = {}  # (L, E, TH) -> [handle] awaiting dispatch

    def flush(bucket=None):
        for b in ([bucket] if bucket is not None else list(staged)):
            hs = staged.pop(b, [])
            if hs:
                dev = (devices[next(n_grp) % len(devices)]
                       if len(devices) > 1 else None)
                with trace.timed("task1.host"):
                    dispatch_chain_group(hs, device=dev)

    def stage(h):
        if G == 1 or getattr(h, "done", None) is not None:
            return  # already dispatched in the prep thread (or finished)
        b = h.key
        staged.setdefault(b, []).append(h)
        if len(staged[b]) >= G:
            flush(b)

    from collections import deque

    # two prep workers: finish-side host work is tiny, so the main
    # thread mostly waits — a second walker keeps a second core busy (the
    # native walker releases the GIL).  NPT_PILEUP_THREADS can pin each
    # prep's internal walker width (default: every core).
    with ThreadPoolExecutor(max_workers=2) as pool:
        it = iter(names_seqs)
        # a streaming source (IndexedBam) shares one file handle + block
        # cache, so its fetches must not run concurrently; in-memory
        # batches keep enough preps in flight to fill a device batch
        prep_depth = 1 if streaming else max(2, G)
        futq: deque = deque()
        for nxt in it:
            futq.append((nxt[0], pool.submit(prep, *nxt)))
            if len(futq) >= prep_depth:
                break
        pending: deque = deque()  # handles in input order
        while futq:
            name, fut = futq.popleft()
            h = fut.result()
            nxt = next(it, None)
            if nxt is not None:
                futq.append((nxt[0], pool.submit(prep, *nxt)))
            stage(h)
            pending.append((name, h))
            # results are fetched several contigs behind their dispatch,
            # giving the device scan + host copy a few full prep slots
            # to stream back before anyone blocks on them.  A streaming
            # source keeps the window tight: its serial BAM fetches are
            # the bottleneck anyway, and every pending handle holds a
            # contig's pileup in RAM (the O(window) memory contract)
            win = 2 if streaming else max(4, G, 2 * len(devices))
            if len(pending) > win:
                pname, ph = pending.popleft()
                if (getattr(ph, "done", None) is None and ph.dev is None
                        and ph.holder is None):
                    flush(ph.key)
                yield pname, score_chain_contig_end(ph)
        flush()
        while pending:
            pname, ph = pending.popleft()
            if (getattr(ph, "done", None) is None and ph.dev is None
                    and ph.holder is None):
                flush(ph.key)
            yield pname, score_chain_contig_end(ph)


# contigs above this many bases go through the reads-sharded multi-chip
# path when more than one device exists (blc can't balance a contig that
# dominates the genome; sharding its READS over chips can)
SHARD_MIN_LEN = 30_000_000


# cells per sharded-chain window: the merge scatters counts + observation
# keys as [Wc * 512] i32 (~1 GB/device at 2^19) and the rank derivation
# argsorts the same shape — 2^19 keeps peak device memory ~3 GB with the
# int32 key space far inside 2^31
SHARD_WINDOW_CELLS = 1 << 19


def score_chain_contig_sharded(name: str, draft: bytes, batch: AlnBatch,
                               cfg: AlgoConfig, mesh, levels=None,
                               window_cells: int | None = None) -> bytes:
    """Task 1 for ONE large contig with its reads sharded over the mesh.

    The qualifying reads split into contiguous BAM-order blocks, one per
    'reads' mesh slot; each shard's sparse pileup walks on host (the
    native walker releases the GIL, so shards walk concurrently), and
    the merge is the on-device psum/pmin collective
    (parallel.shard.make_reads_merge_fwd) — `samtools merge` as a
    collective (source/nextPolish:119-156).  Contigs beyond
    SHARD_WINDOW_CELLS process as a window sequence: the forward scan's
    state vector chains through s0 (pointer decisions are
    shift-invariant, so windowing is byte-exact), and the traceback
    stitches backward from the contig end, resolving each window's
    first-cell running-max placeholder (b_prev == 0) to the previous
    window's msel.  Byte-equal to score_chain_contig by test (including
    a boundary pinned on a divergence-prone cell)."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.tropical import (
        NEG,
        TH_CAP,
        _pow2,
        coverage_thresholds,
        pad_to_chunk,
    )
    from ..parallel.shard import (
        KBIG,
        make_merge_traceback,
        make_reads_merge_fwd,
    )

    tid = batch.header.name2id(name)
    Lc = len(draft)
    if levels is None:
        levels = pl.filter_sgs_chain(batch)
    index = pl.build_cell_index(batch, levels, tid, 0, Lc - 1)
    state = ContigState.from_draft(name, draft, index)
    contig_nib = ASCII_TO_NIB[np.frombuffer(draft, dtype=np.uint8)]
    view = state.index.region_view(0, Lc - 1)
    cell0 = int(state.index.cell_of[0])
    R = int(np.prod(list(mesh.shape.values())))
    n_dp = view.n_cells_dp

    # contiguous read blocks in BAM order (the event stream of shard r
    # precedes shard r+1's, which the merge's key order relies on)
    qual = np.flatnonzero(levels >= 1)
    bounds = [len(qual) * r // R for r in range(R + 1)]

    def build(r):
        lr = np.zeros_like(levels)
        sel = qual[bounds[r]:bounds[r + 1]]
        lr[sel] = levels[sel]
        return pl.build_pileup_sparse(batch, lr, 1, view, tid, contig_nib,
                                      cfg.trim_len_edge,
                                      include_ref=(r == 0))
    with ThreadPoolExecutor(max_workers=min(R, 4)) as pool:
        shards = list(pool.map(build, range(R)))

    total_sum = np.zeros(n_dp, dtype=np.int64)
    for s in shards:
        total_sum += s.total[:n_dp]
    maxt = int(total_sum.max()) if n_dp else 1
    TH = _pow2(min(maxt + 1, TH_CAP))
    th = coverage_thresholds(TH - 1, cfg.min_count_ratio_skip
                             ).astype(np.int32)
    Wc = min(pad_to_chunk(max(n_dp, 1)),
             window_cells or SHARD_WINDOW_CELLS)
    wlos = list(range(0, max(n_dp, 1), Wc))
    sh_r = NamedSharding(mesh, P(mesh.axis_names[0]))
    sh_rep = NamedSharding(mesh, P())

    def put_r(a):
        return jax.device_put(a, sh_r)

    def put(a):
        return jax.device_put(a, sh_rep)

    rate = put(np.float32(cfg.indel_balance_factor_sgs))
    th_d = put(th)
    tbs = []  # per window: (Ptab_dev, flags_dev, msel_dev, n_dp_w)
    s0 = put(np.full(S, float(NEG), np.float32))
    first = True
    for wlo in wlos:
        whi = min(wlo + Wc, n_dp)
        n_dp_w = whi - wlo
        slices = []
        E = 1
        for s in shards:
            a = int(np.searchsorted(s.uk, wlo * K3))
            b = int(np.searchsorted(s.uk, whi * K3))
            slices.append((a, b))
            E = max(E, b - a)
        E = _pow2(E)
        uk = np.full((R, E), Wc * K3, dtype=np.int32)
        cn = np.zeros((R, E), dtype=np.int32)
        key = np.full((R, E), KBIG, dtype=np.int32)
        total_p = np.zeros((R, Wc), dtype=np.int32)
        for r, (s, (a, b)) in enumerate(zip(shards, slices)):
            m = b - a
            uk[r, :m] = s.uk[a:b] - wlo * K3
            cn[r, :m] = np.minimum(s.cn[a:b], 0xFFFF)
            key[r, :m] = (r << 16) | s.rk[a:b].astype(np.int32)
            total_p[r, :n_dp_w] = s.total[wlo:whi]
        refkmer = np.zeros(Wc, dtype=np.int32)
        refkmer[:n_dp_w] = shards[0].refkmer[wlo:whi]
        fwd = make_reads_merge_fwd(mesh, Wc, E, TH)
        Ptab, flags, msel, fend = fwd(
            put_r(uk), put_r(cn), put_r(key), put_r(total_p),
            put(refkmer), th_d, rate, put(np.int32(n_dp_w)), s0,
            put(np.bool_(first)))
        tbs.append((Ptab, flags, msel, n_dp_w))
        s0 = fend
        first = False

    # backward stitch: the traceback seed of window w is the base its
    # successor's first-cell pointer demands
    import jax.numpy as jnp

    tb = make_merge_traceback(mesh, Wc)
    last_P, last_flags, last_msel, last_n = tbs[-1]
    b_end = last_msel[last_n - 1]
    packs = [None] * len(tbs)
    for w in range(len(tbs) - 1, -1, -1):
        Ptab, flags, msel, n_dp_w = tbs[w]
        packed, b_prev = tb(Ptab, flags, b_end)
        packs[w] = (packed, n_dp_w)
        if w:
            # P[0]'s wb2 branch never yields 0 (jnp.where(wb2 != 0, ...)),
            # so b_prev == 0 unambiguously marks the first-cell placeholder:
            # the winning kmer chains through the running max, whose true
            # predecessor is the PREVIOUS window's base_max_score pick at
            # its last valid cell (a no-op when that msel is also 0)
            pmsel, pn = tbs[w - 1][2], tbs[w - 1][3]
            b_end = jnp.where(b_prev == 0, pmsel[pn - 1], b_prev)
    packed = np.concatenate([np.asarray(p)[:nw] for p, nw in packs]) \
        if packs else np.zeros(0, np.int8)
    p0 = shards[0]
    _finish_correction_sparse(state, p0, cell0, packed, cfg)
    maybe_trace(cfg, name, state, draft)
    return state.emit(FLAG_ZERO | FLAG_COVERAGE)


def score_chain_pipeline_multichip(names_seqs, batch, cfg: AlgoConfig,
                                   mesh=None,
                                   shard_min: int = SHARD_MIN_LEN):
    """Production task-1 router: contigs above `shard_min` run through
    the reads-sharded collective path when the mesh has >1 device;
    everything else flows through the pipelined single-chip path.  This
    is the function pipeline.polish_task calls and the multichip dryrun
    exercises."""
    import jax

    if mesh is None and len(jax.devices()) > 1:
        from ..parallel.shard import reads_mesh

        mesh = reads_mesh()
    n_mesh = (int(np.prod(list(mesh.shape.values()))) if mesh is not None
              else 1)
    if n_mesh <= 1:
        yield from score_chain_pipeline(names_seqs, batch, cfg)
        return
    pairs = list(names_seqs)
    big = {n for n, s in pairs if len(s) >= shard_min}
    small = [(n, s) for n, s in pairs if n not in big]
    out = dict(score_chain_pipeline(small, batch, cfg)) if small else {}
    for n, s in pairs:
        if n in big:
            src = batch
            if hasattr(batch, "fetch"):
                tid = batch.header.name2id(n)
                src = batch.fetch(tid, 0, max(len(s) - 1, 0))
            yield n, score_chain_contig_sharded(n, s, src, cfg, mesh)
        else:
            yield n, out[n]


def td_score_chain_contig(name: str, draft: bytes, batch: AlnBatch,
                          cfg: AlgoConfig) -> bytes:
    """Legacy long-read chain variant (td_score_chain1, lib/scorechain.c:17-29):
    lgs filter, lgs balance factor, no lowercase flags in output."""
    tid = batch.header.name2id(name)
    L = len(draft)
    levels = pl.filter_lgs(batch, cfg.max_clip_ratio_lgs)
    index = pl.build_cell_index(batch, levels, tid, 0, L - 1)
    state = ContigState.from_draft(name, draft, index)
    contig_nib = ASCII_TO_NIB[np.frombuffer(draft, dtype=np.uint8)]
    score_correct_region(state, batch, levels, tid, contig_nib, 0, L - 1,
                         filterlevel=1, rate=cfg.indel_balance_factor_lgs,
                         cfg=cfg)
    maybe_trace(cfg, name, state, draft)
    return state.emit(0)
