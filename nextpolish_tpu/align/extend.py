"""Batched banded affine-gap local alignment on device.

Replaces the extension stage of bwa mem / minimap2 (ksw) with a tensor
formulation: one `lax.scan` over read rows, vectorized band rows, and the
within-row deletion recurrence resolved EXACTLY by a cumulative max:

    F[c] = -(gapo+gape) - c*gape + cummax_{c'<c}(H'[c'] + c'*gape)

(the affine F "lazy loop" is a (max,+) linear recurrence, so a cummax with
linear decay solves it in closed form).  Traceback bits are emitted per row
and chased on host, vectorized across the whole batch.

Coordinates: cell (i, c) aligns read base i to ref base j = i + c, c in
[0, B).  The ref window must be length R + B.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(10 ** 7)

# traceback encoding: low 2 bits = H source, bit2 = E open, bit3 = F open
H_START, H_DIAG, H_E, H_F = 0, 1, 2, 3


def _band_align_core(q, t, qlen, tlen, match=1, mismatch=4, gapo=6, gape=1,
                     mode="local", clip5=0, clip3=0):
    """q: [Bt, R] uint8 codes (4=pad); t: [Bt, R+B] codes.

    local mode: Smith-Waterman, cell (i, c) aligns q[i] to t[i+c] and the
    best cell anywhere is the alignment end.
    global mode: Needleman-Wunsch of q[0:qlen) vs the ref segment; cell
    (i, c) maps to ref index j = i + c - off with off = B//2, t must be laid
    out as t[x] = ref[x - off] (host pads x < off), and the forced end cell
    is (qlen-1, tlen - qlen + off).

    clip5/clip3 (local mode) add bwa mem's soft-clip penalties
    (opt_pen_clip5/3, util/bwa/bwamem.c): paths anchored at the query
    start carry a +clip5 bonus (so clipping the 5' end must win by more
    than clip5), and the alignment extends to the query end whenever the
    best last-row score is within clip3 of the local optimum.  The
    returned score still includes the 5' bonus; band_align_ops subtracts
    it once the traceback shows the path reached query base 0.

    mode="extend" gives ksw extension semantics (the *_extend role of
    bwa/minimap2): the path is pinned at query base 0 / ref offset 0
    (gap penalties decay from the corner via the clip5 pin bonus), the
    end is free (best cell anywhere), and band_align_ops subtracts the
    pin bonus from the reported score.

    Returns (tb [Bt, R, B] uint8, best score, end row, end col per read).
    """
    Bt, R = q.shape
    B = t.shape[1] - R
    cidx = jnp.arange(B)
    extend = mode == "extend"
    local = mode == "local" or extend
    off = 0 if local else B // 2

    def row(carry, qi_i):
        Hprev, Eprev, Hfin, i = carry
        qi = qi_i
        tj = jnp.take_along_axis(
            t, (i + cidx)[None, :].repeat(Bt, 0), axis=1
        )
        valid_q = (qi < 4) & (i < qlen[:, None])
        j = (i + cidx - off)[None, :]
        valid_t = (tj < 4) & (j < tlen[:, None]) & (j >= 0)
        sub = jnp.where(qi == tj, match, -mismatch)
        sub = jnp.where(valid_q & valid_t, sub, NEG)

        Hup = jnp.concatenate(
            [Hprev[:, 1:], jnp.full((Bt, 1), NEG, Hprev.dtype)], axis=1
        )
        Eup = jnp.concatenate(
            [Eprev[:, 1:], jnp.full((Bt, 1), NEG, Eprev.dtype)], axis=1
        )
        e_open = Hup - gapo >= Eup
        E = jnp.maximum(Hup - gapo, Eup) - gape
        diag = Hprev + sub
        Hp = jnp.maximum(diag, E)
        if local:
            Hp = jnp.maximum(Hp, 0)
        # F via cummax with linear decay (exact affine in-row recurrence)
        decay = Hp + cidx[None, :] * gape
        cm = jax.lax.cummax(decay, axis=1)
        cm_shift = jnp.concatenate(
            [jnp.full((Bt, 1), NEG, cm.dtype), cm[:, :-1]], axis=1
        )
        F = cm_shift - (gapo + gape) - cidx[None, :] * gape
        Hp_shift = jnp.concatenate(
            [jnp.full((Bt, 1), NEG, Hp.dtype), (Hp + cidx[None] * gape)[:, :-1]],
            axis=1,
        )
        f_open = Hp_shift >= cm_shift
        H = jnp.maximum(Hp, F)

        if local:
            src = jnp.where(H == 0, H_START,
                            jnp.where(H == F, H_F,
                                      jnp.where(H == diag, H_DIAG, H_E)))
            src = jnp.where((H == diag) & (H > 0), H_DIAG, src)
        else:
            src = jnp.where(H == F, H_F,
                            jnp.where(H == diag, H_DIAG, H_E))
            src = jnp.where(H == diag, H_DIAG, src)
        tb = (src.astype(jnp.uint8)
              | (e_open.astype(jnp.uint8) << 2)
              | (f_open.astype(jnp.uint8) << 3))
        best = jnp.max(H, axis=1)
        argc = jnp.argmax(H, axis=1)
        Hfin = jnp.where((i == qlen - 1)[:, None], H, Hfin)
        return (H, E, Hfin, i + 1), (tb, best, argc)

    if extend:
        # pin the start at the window corner: ref offsets > 0 open a
        # deletion from the anchor (gap decay), so spurious free-start
        # deletions cost what they should
        H0 = jnp.where(cidx[None, :] == 0, clip5,
                       clip5 - (gapo + cidx[None, :] * gape)
                       ).astype(jnp.int32).repeat(Bt, 0)
    elif local:
        H0 = jnp.full((Bt, B), clip5, jnp.int32)
    else:
        # virtual row i=-1: j = c - 1 - off; 0 at j=-1, leading-deletion
        # penalties for j >= 0, NEG left of the start
        H0 = jnp.where(cidx[None, :] == off, 0,
                       jnp.where(cidx[None, :] > off,
                                 -(gapo + (cidx[None, :] - off) * gape),
                                 NEG)).astype(jnp.int32).repeat(Bt, 0)
    E0 = jnp.full((Bt, B), NEG, jnp.int32)
    Hfin0 = jnp.full((Bt, B), NEG, jnp.int32)
    (_, _, Hfin, _), (tb, best_rows, argc_rows) = jax.lax.scan(
        row, (H0, E0, Hfin0, jnp.int32(0)), q.T[:, :, None].astype(jnp.int32)
    )
    if local:
        best_i = jnp.argmax(best_rows, axis=0)
        best = jnp.take_along_axis(best_rows, best_i[None], axis=0)[0]
        best_c = jnp.take_along_axis(argc_rows, best_i[None], axis=0)[0]
        if clip3:
            # prefer reaching the query end when within clip3 of optimal
            g_best = jnp.max(Hfin, axis=1)
            g_c = jnp.argmax(Hfin, axis=1)
            use_g = (g_best > 0) & (g_best + clip3 >= best)
            best = jnp.where(use_g, g_best, best)
            best_i = jnp.where(use_g, qlen - 1, best_i)
            best_c = jnp.where(use_g, g_c, best_c)
    else:
        best_i = qlen - 1
        best_c = tlen - qlen + off
        best = jnp.take_along_axis(Hfin, best_c[:, None], axis=1)[:, 0]
    return tb.transpose(1, 0, 2), best, best_i, best_c


_band_align = partial(jax.jit, static_argnames=(
    "match", "mismatch", "gapo", "gape", "mode", "clip5",
    "clip3"))(_band_align_core)


def _traceback_device(tb, end_i, end_c):
    """The traceback state machine of `traceback_batch`, on device: a
    while_loop over steps, vectorized over the batch, so the [Bt, R, B]
    traceback tensor never leaves the device (only the packed op stream
    is fetched).

    Returns (packed ops [Bt, S/4] uint8, 2-bit op+1 codes little-endian
    within each byte, final i, final c)."""
    Bt, R, B = tb.shape
    max_steps = -(-(2 * R + B + 4) // 4) * 4  # multiple of 4 for packing
    i0 = end_i.astype(jnp.int32)
    c0 = end_c.astype(jnp.int32)
    # ops is [S, Bt] so each step writes one contiguous row
    st0 = (jnp.int32(0), i0, c0, jnp.zeros(Bt, jnp.int32),
           jnp.zeros(Bt, jnp.bool_), jnp.zeros((max_steps, Bt), jnp.uint8))
    rows = jnp.arange(Bt)

    def cond(st):
        step, _, _, _, done, _ = st
        return (step < max_steps) & ~jnp.all(done)

    def body(st):
        step, i, c, state, done, ops = st
        done = done | (i < 0)
        inb = (~done) & (i >= 0) & (c >= 0) & (c < B)
        cell = tb[rows, jnp.clip(i, 0, R - 1), jnp.clip(c, 0, B - 1)]
        cell = jnp.where(inb, cell, 0).astype(jnp.int32)
        hsrc = cell & 3
        mH = inb & (state == 0)
        start = mH & (hsrc == H_START)
        diag = mH & (hsrc == H_DIAG)
        toE = mH & (hsrc == H_E)
        toF = mH & (hsrc == H_F)
        mE = inb & (state == 1)
        mF = inb & (state == 2)
        act = jnp.where(diag, _M + 1,
                        jnp.where(mE, _I + 1,
                                  jnp.where(mF, _D + 1, 0))).astype(jnp.uint8)
        eopen = (cell >> 2) & 1
        fopen = (cell >> 3) & 1
        i = i - diag.astype(jnp.int32) - mE.astype(jnp.int32)
        c = c + mE.astype(jnp.int32) - mF.astype(jnp.int32)
        state = jnp.where(toE, 1, jnp.where(toF, 2, state))
        state = jnp.where(mE & (eopen == 1), 0, state)
        state = jnp.where(mF & (fopen == 1), 0, state)
        ops = jax.lax.dynamic_update_slice(ops, act[None, :], (step, 0))
        return (step + 1, i, c, state, done | start, ops)

    _, i, c, _, _, ops = jax.lax.while_loop(cond, body, st0)
    # ops values fit in 2 bits: pack 4 steps/byte to quarter the fetch
    packed = (ops[0::4] | (ops[1::4] << 2) | (ops[2::4] << 4)
              | (ops[3::4] << 6))
    return packed.T, i, c


@partial(jax.jit,
         static_argnames=("match", "mismatch", "gapo", "gape", "mode",
                          "clip5", "clip3"))
def _band_align_ops(q, t, qlen, tlen, match=1, mismatch=4, gapo=6, gape=1,
                    mode="local", clip5=0, clip3=0):
    tb, best, best_i, best_c = _band_align_core(
        q, t, qlen, tlen, match=match, mismatch=mismatch, gapo=gapo,
        gape=gape, mode=mode, clip5=clip5, clip3=clip3)
    ops, fin_i, fin_c = _traceback_device(tb, best_i, best_c)
    return ops, best, best_i, best_c, fin_i, fin_c


def band_align_ops(q_codes: np.ndarray, t_codes: np.ndarray, qlen: np.ndarray,
                   tlen: np.ndarray, match=1, mismatch=4, gapo=6, gape=1,
                   mode="local", clip5=0, clip3=0):
    """Fused align + traceback: numpy in, numpy out, with the traceback run
    on device so only the op stream (not the [Bt, R, B] tensor) is fetched.

    Returns (ops [Bt, S] of op+1 codes end->start, score, i_lo, j_lo,
    i_hi, j_hi, lead_del) — the union of band_align + traceback_batch."""
    n = q_codes.shape[0]
    nb = 1
    while nb < n:
        nb *= 2
    if nb != n:
        q_codes = np.concatenate(
            [q_codes, np.full((nb - n, q_codes.shape[1]), 4, q_codes.dtype)])
        t_codes = np.concatenate(
            [t_codes, np.full((nb - n, t_codes.shape[1]), 4, t_codes.dtype)])
        qlen = np.concatenate([qlen, np.zeros(nb - n, qlen.dtype)])
        tlen = np.concatenate([tlen, np.ones(nb - n, tlen.dtype)])
    B = t_codes.shape[1] - q_codes.shape[1]
    off = B // 2 if mode == "global" else 0
    out = _band_align_ops(
        jnp.asarray(q_codes), jnp.asarray(t_codes),
        jnp.asarray(qlen, dtype=jnp.int32), jnp.asarray(tlen, dtype=jnp.int32),
        match=match, mismatch=mismatch, gapo=gapo, gape=gape, mode=mode,
        clip5=clip5, clip3=clip3)
    # one batched fetch of every output
    packed, sc, ei, ec, fi, fc = jax.device_get(out)
    packed = packed[:n]
    ops = ((packed[:, :, None] >> (2 * np.arange(4, dtype=np.uint8))) & 3
           ).astype(np.int8).reshape(n, -1)
    sc = sc[:n]
    ei = ei[:n].astype(np.int64)
    ec = ec[:n].astype(np.int64)
    fi = fi[:n].astype(np.int64)
    fc = fc[:n].astype(np.int64)
    i_hi = ei
    j_hi = ei + ec - off
    i_lo = fi + 1
    j_lo = fi + fc + 1 - off
    if mode == "global":
        lead_del = np.where((fi < 0) & (fc - off > 0), fc - off, 0)
        j_lo = j_lo - lead_del
    else:
        lead_del = np.zeros(n, dtype=np.int64)
    if mode in ("local", "extend") and clip5:
        # the +clip5 start-anchor bonus is not part of the real score
        sc = sc - np.where(i_lo == 0, clip5, 0)
    return ops, sc, i_lo, j_lo, i_hi, j_hi, lead_del


def band_align(q_codes: np.ndarray, t_codes: np.ndarray, qlen: np.ndarray,
               tlen: np.ndarray, match=1, mismatch=4, gapo=6, gape=1,
               mode="local"):
    """Host wrapper; returns numpy (tb, score, end_i, end_c).

    The batch dimension is padded to a power of two so jit sees a bounded
    set of shapes (a fresh compile per distinct batch size was the top
    cost on this host)."""
    n = q_codes.shape[0]
    nb = 1
    while nb < n:
        nb *= 2
    if nb != n:
        q_codes = np.concatenate(
            [q_codes, np.full((nb - n, q_codes.shape[1]), 4, q_codes.dtype)])
        t_codes = np.concatenate(
            [t_codes, np.full((nb - n, t_codes.shape[1]), 4, t_codes.dtype)])
        qlen = np.concatenate([qlen, np.zeros(nb - n, qlen.dtype)])
        tlen = np.concatenate([tlen, np.ones(nb - n, tlen.dtype)])
    tb, sc, bi, bc = _band_align(
        jnp.asarray(q_codes), jnp.asarray(t_codes),
        jnp.asarray(qlen, dtype=jnp.int32), jnp.asarray(tlen, dtype=jnp.int32),
        match=match, mismatch=mismatch, gapo=gapo, gape=gape, mode=mode,
    )
    return (np.asarray(tb)[:n], np.asarray(sc)[:n], np.asarray(bi)[:n],
            np.asarray(bc)[:n])


# CIGAR op codes (BAM)
_M, _I, _D, _S = 0, 1, 2, 4


def traceback_batch(tb: np.ndarray, end_i: np.ndarray, end_c: np.ndarray,
                    qlen: np.ndarray, mode: str = "local"):
    """Vectorized traceback over the whole batch.

    Returns (ops matrix [Bt, steps] of per-step op+1 codes, read_start,
    ref_start j_lo, read_end i_hi (inclusive), ref_end j_hi, lead_del).
    In global mode ref index j = i + c - B//2 and lead_del counts leading
    deletions implied by finishing left of the virtual origin."""
    Bt, R, B = tb.shape
    off = B // 2 if mode == "global" else 0
    i = end_i.astype(np.int64).copy()
    c = end_c.astype(np.int64).copy()
    state = np.zeros(Bt, dtype=np.int8)  # 0=H, 1=E, 2=F
    done = np.zeros(Bt, dtype=bool)
    max_steps = 2 * R + B + 4
    ops = np.full((Bt, max_steps), -1, dtype=np.int8)
    # record end coordinates
    i_hi = end_i.astype(np.int64)
    j_hi = end_i.astype(np.int64) + end_c.astype(np.int64) - off
    step = 0
    while not done.all() and step < max_steps:
        done |= i < 0
        inb = (~done) & (i >= 0) & (c >= 0) & (c < B)
        cell = np.zeros(Bt, dtype=np.uint8)
        cell[inb] = tb[np.nonzero(inb)[0], i[inb], c[inb]]
        hsrc = cell & 3
        act = np.zeros(Bt, dtype=np.int8)  # op emitted this step
        # H state
        mH = inb & (state == 0)
        start = mH & (hsrc == H_START)
        done |= start
        diag = mH & (hsrc == H_DIAG)
        act[diag] = _M + 1  # +1 so 0 = none
        toE = mH & (hsrc == H_E)
        toF = mH & (hsrc == H_F)
        state[toE] = 1
        state[toF] = 2
        # E state: consume read base (I), move to (i-1, c+1)
        mE = inb & (state == 1) & ~mH
        act[mE] = _I + 1
        eopen = (cell >> 2) & 1
        # F state: consume ref base (D), move to (i, c-1)
        mF = inb & (state == 2) & ~mH
        act[mF] = _D + 1
        fopen = (cell >> 3) & 1
        # apply moves
        i[diag] -= 1
        i[mE] -= 1
        c[mE] += 1
        c[mF] -= 1
        state[mE & (eopen == 1)] = 0
        state[mF & (fopen == 1)] = 0
        ops[:, step] = act
        step += 1
    # start coords: after traceback, (i, c) sits one move above the first
    # aligned cell for diag/E (i already decremented) -> read start = i + 1
    i_lo = i + 1
    j_lo = i + c + 1 - off
    if mode == "global":
        lead_del = np.where((i < 0) & (c - off > 0), c - off, 0)
        j_lo = j_lo - lead_del  # leading dels start at ref 0 of the segment
    else:
        lead_del = np.zeros(Bt, dtype=np.int64)
    return ops[:, :step], i_lo, j_lo, i_hi, j_hi, lead_del


def runs_to_cigar(op_row: np.ndarray, i_lo: int, i_hi: int, qlen: int
                  ) -> np.ndarray:
    """Convert one read's reversed op stream to a CIGAR uint32 array with
    soft clips."""
    ops = op_row[op_row > 0] - 1
    ops = ops[::-1]  # traceback emitted end->start
    cig = []
    if i_lo > 0:
        cig.append((int(i_lo) << 4) | _S)
    if ops.size:
        change = np.flatnonzero(np.diff(ops) != 0)
        bounds = np.concatenate([[-1], change, [ops.size - 1]])
        for a, b in zip(bounds[:-1], bounds[1:]):
            cig.append((int(b - a) << 4) | int(ops[a + 1]))
    tail = qlen - 1 - i_hi
    if tail > 0:
        cig.append((int(tail) << 4) | _S)
    return np.array(cig, dtype=np.uint32)
