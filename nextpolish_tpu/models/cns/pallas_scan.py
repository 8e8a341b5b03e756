"""Pallas (Triton route) kernel for the engine-2 level scan (device_dp.py).

The link DP is sequential over a window's (t_pos, delta) levels, and one
level is only ~6*E entries of work, so the parallel axis is WINDOWS — the
same axis the reference parallelises with worker processes (the window
loop, lib/ctg_cns.c:3455-3594).  The kernel runs one program per window;
each program walks all of its window's levels in a loop, so the whole
scan is one launch with no per-level round trip through the host.

Per level a program holds the level's entries as an [8, Ep] tile (6 base
cells padded to 8, E entry slots padded to a power of two) and:

  1. gathers every entry's predecessor cell row from the DP carry — the
     boundary ring (d0 levels) or the previous level — with one indexed
     load from the carry buffer (an extra kernel output that stays in
     L1/L2); the next level's tiles load at the same time;
  2. scores all entries at once (match-masked max, last matching slot);
  3. picks each cell's winner with the read-type rules, unrolled over the
     E slots in insertion order exactly like the C loop, reading each
     slot's column back from a per-program scratch (reductions over the
     slot axis cost ~10x more per level on the H100);
  4. writes the winners, then the new carry rows (ring reset on d0
     levels, ring slot, previous level), with block barriers around the
     scratch and carry writes so later loads see them.

4 warps per program measured fastest (2 and 8 were slower on the H100).

Semantics are bit-identical to device_dp._dp_level (tested against the
lax.scan path in tests/test_device_dp.py, which is in turn
byte-parity-tested against the host engines).  All arithmetic is int32.
"""
from __future__ import annotations

from functools import partial

from .device_dp import (
    F_COND1A,
    F_COND2B,
    F_HEAD,
    F_PPB_NOT_GAP,
    F_VALID,
    NEG,
    NEGINIT,
)

F_MATCH = 32  # kernel-local: entry has a matching predecessor

CELLS = 8  # 6 base cells padded to a power of two (Triton tensor sizes)
FL, SC, NB, NL = range(4)  # per-entry tiles the selection reads


def pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _kernel(A_ref, M_ref, meta_ref, nlev_ref, best_ref, sc_ref, src_ref,
            cols_ref, *, E, Ep, Vb, rt_id, cov_coef, sync):
    """One program = one window.  A/M [B, NCL, 8, Ep], meta [B, NCL],
    nlev [B]; outputs best/sc [B, NCL, 8]; src_ref [B, Vbp+1, 8, Ep] is
    the DP carry: ring slots 0..Vbp-1, previous level at slot Vbp;
    cols_ref [B, 4, 8, Ep] holds the per-entry tiles the winner selection
    reads back column by column."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    i32 = jnp.int32
    Vbp = src_ref.shape[1] - 1
    b = pl.program_id(0)
    nidx = jax.lax.broadcasted_iota(i32, (CELLS, Ep, Ep), 2)
    ring_slot = jax.lax.broadcasted_iota(i32, (Vbp, CELLS, Ep), 0)
    nlev = nlev_ref[b]

    def barrier():
        if sync:  # a real block barrier; the interpreter runs in order
            from jax.experimental.pallas import triton as plgpu

            plgpu.debug_barrier()

    src_ref[b, pl.ds(0, Vbp)] = jnp.full((Vbp, CELLS, Ep), NEG, i32)
    src_ref[b, Vbp] = jnp.full((CELLS, Ep), NEG, i32)
    barrier()


    def load(l):
        l = jnp.maximum(jnp.minimum(l, nlev - 1), 0)
        return A_ref[b, l], M_ref[b, l], meta_ref[b, l]

    def level(l, cur):
        # the next level's inputs load now; their latency hides behind
        # this level's work
        nxt = load(l + 1)
        a, m, meta = cur
        cov = meta >> 8
        vslot = ((meta >> 2) & 0x3F) - 1
        is_d0 = ((meta >> 1) & 1) != 0

        link = a >> 16
        ppi = (a >> 8) & 0xFF
        flags = a & 0xFF
        valid = (flags & F_VALID) != 0
        is_head = (flags & F_HEAD) != 0
        w = 10 * link - cov_coef * cov

        # predecessor rows: pp_idx = ring_slot * 6 + cell, where ring slot
        # Vb (the bucket's) means the previous level
        pslot = jax.lax.div(ppi, 6)
        pcell = ppi - pslot * 6
        pslot = jnp.where(pslot >= Vb, Vbp, pslot)
        pred = src_ref[b, jnp.broadcast_to(pslot[:, :, None], nidx.shape),
                       jnp.broadcast_to(pcell[:, :, None], nidx.shape),
                       nidx]  # [8, Ep, Ep]
        mbits = ((m[:, :, None] >> nidx) & 1) != 0
        n_best = jnp.max(jnp.where(mbits, pred, NEG), axis=2)
        last = jnp.maximum(jnp.max(jnp.where(mbits, nidx, -1), axis=2), 0)
        n_last = jnp.sum(jnp.where(nidx == last[:, :, None], pred, 0),
                         axis=2)
        has_match = n_best > NEG // 2
        sc = jnp.where(is_head, w,
                       jnp.where(has_match, jnp.maximum(n_best + w, 0), 0))
        sc = jnp.where(valid, sc, NEG)
        # the selection walks slots in order: stage the per-entry tiles
        # in the program's scratch and read them back one column (slot)
        # at a time — the loads do not depend on the selection state, so
        # they all issue up front
        fl = flags | jnp.where(has_match, F_MATCH, 0) | (link << 8)
        for k, x in enumerate((fl, sc, n_best, n_last)):
            cols_ref[b, k] = x
        barrier()

        def col(k, e):
            """Column e of tile k as an [8] vector."""
            return cols_ref[b, k, :, e]

        # ---- winning-entry selection, unrolled over slots ----
        bm = jnp.zeros((CELLS,), i32)
        sc_bm = col(SC, 0)
        link_bm = col(FL, 0) >> 8
        p_pp = jnp.full((CELLS,), NEGINIT, i32)
        raiser = jnp.full((CELLS,), NEGINIT, i32)
        if rt_id == 0:  # ont: tmp = max link over valid entries per cell
            tmp = jnp.max(jnp.where(valid, link, 0), axis=1)
        for e in range(E):
            fe = col(FL, e)
            sc_e = col(SC, e)
            nb_e = col(NB, e)
            ln_e = fe >> 8
            v = (fe & F_VALID) != 0
            hm = v & ((fe & F_HEAD) == 0) & ((fe & F_MATCH) != 0)
            ppb_ng = (fe & F_PPB_NOT_GAP) != 0
            raiser = jnp.where(v & (sc_e > 0), nb_e, raiser)
            if rt_id in (1, 3):  # clr / hifi
                upd = hm & ((nb_e > p_pp) | ((nb_e == p_pp) & ppb_ng))
                bm = jnp.where(upd, e, bm)
                sc_bm = jnp.where(upd, sc_e, sc_bm)
                link_bm = jnp.where(upd, ln_e, link_bm)
                p_pp = jnp.where(upd, nb_e, p_pp)
            elif rt_id == 0:  # ont
                c1 = hm & ((fe & F_COND1A) != 0) & (
                    (5 * ln_e > cov) | (ln_e > jax.lax.div(tmp, 2)))
                c2 = (~c1 & hm & (ln_e > jax.lax.div(link_bm, 2))
                      & (nb_e > p_pp) & ((fe & F_COND2B) != 0))
                upd = c1 | c2
                bm = jnp.where(upd, e, bm)
                sc_bm = jnp.where(upd, sc_e, sc_bm)
                link_bm = jnp.where(upd, ln_e, link_bm)
                p_pp = jnp.where(c1, col(NL, e),
                                 jnp.where(c2, nb_e, p_pp))
            # common final rule
            if rt_id == 2:  # rs
                upd = v & (sc_e >= sc_bm)
            else:
                upd = v & ((sc_e > sc_bm) | ((sc_e == sc_bm) & ppb_ng))
            bm = jnp.where(upd, e, bm)
            sc_bm = jnp.where(upd, sc_e, sc_bm)
            link_bm = jnp.where(upd, ln_e, link_bm)
            p_pp = jnp.where(upd, raiser, p_pp)
        best_ref[b, l] = bm
        sc_ref[b, l] = sc_bm

        # ---- carry update: every gather of this level is done first ----
        barrier()

        @pl.when(is_d0)
        def _():  # new position: reset the ring, then stage this level
            src_ref[b, pl.ds(0, Vbp)] = jnp.where(
                ring_slot == vslot, jnp.broadcast_to(sc, ring_slot.shape),
                NEG)

        @pl.when(~is_d0 & (vslot >= 0))
        def _():
            src_ref[b, vslot] = sc

        src_ref[b, Vbp] = sc
        barrier()
        return nxt

    jax.lax.fori_loop(0, nlev, level, load(0))


def level_scan_call(E: int, Vb: int, rt_id: int, cov_coef: int,
                    B: int, NCL: int, platform: str):
    """pallas_call for B windows of up to NCL levels in the (E, Vb) bucket:
    f(A [B,NCL,8,Ep], M, meta [B,NCL], nlev [B]) -> (best, sc) [B,NCL,8].

    `platform` names the route: "gpu" compiles through Triton; "cpu" runs
    the same kernel in the Pallas interpreter (tests); anything else
    raises."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    if platform == "gpu":
        from jax.experimental.pallas import triton as plgpu

        extra = dict(backend="triton",
                     compiler_params=plgpu.CompilerParams(
                         num_warps=4, num_stages=1))
        interpret = False
    elif platform == "cpu":
        extra = {}
        interpret = True
    else:
        raise RuntimeError(
            f"engine-2 level-scan kernel has no route for platform "
            f"{platform!r} (gpu: Triton; cpu: interpreter)")
    Ep = pow2(E)
    Vbp = pow2(Vb)
    kern = partial(_kernel, E=E, Ep=Ep, Vb=Vb, rt_id=rt_id,
                   cov_coef=cov_coef, sync=not interpret)
    call = pl.pallas_call(
        kern,
        grid=(B,),
        out_shape=[
            jax.ShapeDtypeStruct((B, NCL, CELLS), jnp.int32),
            jax.ShapeDtypeStruct((B, NCL, CELLS), jnp.int32),
            jax.ShapeDtypeStruct((B, Vbp + 1, CELLS, Ep), jnp.int32),
            jax.ShapeDtypeStruct((B, 4, CELLS, Ep), jnp.int32),
        ],
        interpret=interpret,
        name="cns_level_scan",
        **extra,
    )

    def run(A, M, meta, nlev):
        best, sc, _, _ = call(A, M, meta, nlev)
        return best, sc

    return run
