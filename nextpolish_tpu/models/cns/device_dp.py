"""Device path for the engine-2 link DP (get_cns_from_align_tags,
lib/ctg_cns.c:1876-2144) — a fixed-shape tensor program over the MSA.

Reformulation: the sparse (t_pos, delta, q_base) lattice becomes a flat
sequence of *levels* (one level per occupied (t_pos, delta) pair, in DP
order); every level holds exactly the 6 base cells, each with up to E
entry slots in reference insertion order.  A `lax.scan` walks the levels:

  - within a position, level d's predecessors live in level d-1 (carried
    as `prev_level`), because a read's insertion run increments delta by
    exactly one per column;
  - across positions, a delta-0 level's predecessors are the *chain-end*
    cells of the previous position — only a handful of its levels are ever
    referenced, so their scores are staged into a small boundary ring
    (`bnd`, [Vb, 6, E]) that rotates when a new position starts.

Scores are int32 (the C uses int64; densify_window checks an upper bound
and refuses windows that could overflow).  All tie-break inputs that the
read-type rules need (cond1's delta tests, cond2's base identities, the
"pp base is not a gap" upgrades) are precomputed on the host into per-entry
flag bits, so the device step is branch-free apart from the read-type
selection, which is unrolled over the E entry slots exactly like the C's
insertion-order loop.  Giant insertion chains (delta in the thousands)
need no special casing — they are just more levels.

The scan emits per-level winners (best entry slot + its score per cell);
the host maps them back onto the EdgeTable and reuses dp.traceback, so
byte-parity with the host paths is structural.  On the GPU the scan is the
Pallas kernel in pallas_scan.py (one program per window); the plain
lax.scan below is its reference and the CPU backend's scan.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

from .dp import COV_COEF, Consensus, traceback
from .msa import EdgeTable, build_edges, unpack_keys
from .tags import GAP

NEG = -(2 ** 29)  # masked-out candidate score
NEGINIT = -(2 ** 30)  # "unset" p_pp / raiser (C uses INT64_MIN)

F_VALID = 1
F_HEAD = 2
F_COND1A = 4  # ONT: ppp_d > 1 or pp_d > 0
F_COND2B = 8  # ONT: pp_b==GAP or pp_b==b or ppp_b==b or pp_b==ppp_b
F_PPB_NOT_GAP = 16  # tie upgrade: entry's pp base is not a gap

READ_TYPE_ID = {"ont": 0, "clr": 1, "rs": 2, "hifi": 3}


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p

# caps beyond which densify refuses (fallback to the host paths):
# match bits live in an int32 word, the ring slot in a 6-bit meta field
MAX_E = 24
MAX_VB = 24


@dataclass
class DenseWindow:
    """Entry-major packed level data + host-only maps for traceback.
    Entries stay as flat [Et] vectors (tag-major, slot ascending) and are
    scattered straight into the batch slab at launch — no dense
    [Lt, 6, E] intermediates on the host."""

    ent_lvl: np.ndarray  # int64 [Et] level index
    ent_b: np.ndarray  # int8 [Et] base cell 0..5
    ent_slot: np.ndarray  # int8 [Et] entry slot (insertion order)
    ent_A: np.ndarray  # int32 [Et] (link<<16)|(pp_idx<<8)|flags
    ent_M: np.ndarray  # int32 [Et] match bits
    ent_same: np.ndarray  # bool [Et] pp_idx points at the same-pos section
    meta: np.ndarray  # int32 [Lt] (cov<<8)|((vslot+1)<<2)|(is_d0<<1)
    eorder: np.ndarray  # int64 [Et] absolute EdgeTable index per entry
    level_pos: np.ndarray  # int32 [Lt]
    n_levels: int
    Vb: int
    E: int
    edges: EdgeTable
    length: int


def densify_window(edges: EdgeTable, coverage: np.ndarray, length: int
                   ) -> DenseWindow | None:
    """EdgeTable -> DenseWindow, or None when the window exceeds the
    device caps / int32 score range (caller falls back to host)."""
    Tn = len(edges.tag_key)
    if Tn == 0:
        return None
    tp, td, tb = unpack_keys(edges.tag_key)
    ent_n = np.diff(edges.tag_off)
    E = int(ent_n.max())
    if E > MAX_E:
        return None

    # ---- levels: unique (p, d) in DP order (tag keys are sorted) -------
    lvl_key = edges.tag_key >> 3
    new_lvl = np.ones(Tn, dtype=bool)
    new_lvl[1:] = lvl_key[1:] != lvl_key[:-1]
    lvl_of_tag = np.cumsum(new_lvl) - 1
    lstarts = np.flatnonzero(new_lvl)
    Lt = len(lstarts)
    level_pos = tp[lstarts].astype(np.int32)
    level_d = td[lstarts].astype(np.int32)
    is_d0 = level_d == 0

    # int32 score-overflow guard: sum over levels of the largest positive
    # per-entry increment bounds any chain score
    c = 3  # smallest cov coefficient gives the largest increment bound
    # tags are contiguous per level: per-tag max then per-level max,
    # both as reduceat over the sorted layout
    tag_link_max = np.maximum.reduceat(
        edges.link.astype(np.int64), edges.tag_off[:-1])
    link_max = np.maximum.reduceat(tag_link_max, lstarts)
    inc = np.maximum(10 * link_max - c * coverage[level_pos], 0)
    if int(inc.sum()) >= 2 ** 30:
        return None
    if int(link_max.max()) >= 2 ** 15:  # link packs into 16 bits of A
        return None

    # ---- entry slots: insertion order within each cell -----------------
    # everything below is entry-major (flat [E_total]) with one scatter
    # into the [Lt, 6, E] dense arrays at the end
    Et = len(edges.cur)
    tag_of_entry = np.repeat(np.arange(Tn, dtype=np.int64), ent_n)
    eorder = np.lexsort((edges.ins, tag_of_entry))
    slot_sorted = (np.arange(Et, dtype=np.int64)
                   - np.repeat(edges.tag_off[:-1], ent_n))

    lvl_e = lvl_of_tag[tag_of_entry]
    b_e = tb[tag_of_entry].astype(np.int64)
    link_e = edges.link[eorder].astype(np.int32)
    pp_e = edges.pp[eorder]
    ppp_e = edges.ppp[eorder]
    head_e = pp_e < 0
    ppd = np.where(head_e, 0, (pp_e >> 3) & ((1 << 17) - 1))
    ppb = np.where(head_e, 0, pp_e & 7)
    hppp = ppp_e < 0
    pppd = np.where(hppp, 0, (ppp_e >> 3) & ((1 << 17) - 1))
    pppb = np.where(hppp, 0, ppp_e & 7)

    flags_e = np.full(Et, F_VALID, dtype=np.uint8)
    flags_e |= np.where(head_e, F_HEAD, 0).astype(np.uint8)
    flags_e |= np.where((pppd > 1) | (ppd > 0), F_COND1A, 0).astype(
        np.uint8)
    flags_e |= np.where((ppb == GAP) | (ppb == b_e) | (pppb == b_e)
                        | (ppb == pppb), F_COND2B, 0).astype(np.uint8)
    flags_e |= np.where(ppb != GAP, F_PPB_NOT_GAP, 0).astype(np.uint8)

    # ---- boundary ring: levels referenced as pp by next-position d0 ----
    # pp of a d0 entry is the read's last column at p-1 (any level there)
    d0_e = is_d0[lvl_e]
    lkeys = (level_pos.astype(np.int64) << 17) | level_d.astype(np.int64)
    ref_keys = np.unique(pp_e[d0_e & ~head_e] >> 3)
    ref_lvl = np.searchsorted(lkeys, ref_keys)
    ok = (ref_lvl < Lt) & (lkeys[np.minimum(ref_lvl, Lt - 1)] == ref_keys)
    ref_lvl = ref_lvl[ok]
    # assign ring slots per position in order of appearance
    vslot = np.full(Lt, -1, dtype=np.int32)
    if len(ref_lvl):
        rp = level_pos[ref_lvl]
        firsts = np.ones(len(ref_lvl), dtype=bool)
        firsts[1:] = rp[1:] != rp[:-1]
        grp = np.cumsum(firsts) - 1
        gstart = np.flatnonzero(firsts)
        vslot[ref_lvl] = (np.arange(len(ref_lvl)) - gstart[grp]).astype(
            np.int32)
    Vb = int(vslot.max()) + 1 if len(ref_lvl) else 1
    if Vb > MAX_VB:
        return None
    Vb = max(Vb, 1)

    # ---- pp_idx: gather index into concat(bnd [Vb*6,E], prev [6,E]) ----
    # d0 levels gather from the boundary ring slot of their pp level;
    # d>0 levels gather from the previous level (their pp is (p, d-1))
    pp_lvl_key = pp_e >> 3
    pos_pp = np.minimum(np.searchsorted(lkeys, pp_lvl_key), Lt - 1)
    pp_vs = np.maximum(
        np.where(lkeys[pos_pp] == pp_lvl_key, vslot[pos_pp], 0), 0)
    pp_idx_e = np.where(d0_e, pp_vs * 6 + ppb, Vb * 6 + ppb)
    pp_idx_e = np.where(head_e, 0, pp_idx_e).astype(np.int32)

    # ---- match bits: pred-cell entries whose pp equals our ppp ---------
    # per tag: its entries' pp keys in slot order
    tag_pp = np.full((Tn, E), -2, dtype=np.int64)
    tag_pp[tag_of_entry, slot_sorted] = pp_e
    # pred tag id for each entry (the cell keyed by our pp)
    pred_tag = np.minimum(np.searchsorted(edges.tag_key, pp_e), Tn - 1)
    pred_ok = edges.tag_key[pred_tag] == pp_e
    m = tag_pp[pred_tag] == ppp_e[:, None]  # [Et, E]
    m &= (pred_ok & ~head_e)[:, None]
    weights = (1 << np.arange(E, dtype=np.uint64)).astype(np.uint64)
    match_e = (m.astype(np.uint64) * weights[None]).sum(axis=1).astype(
        np.uint32)

    # ---- entry-major packed words + per-level meta ---------------------
    ent_A = ((link_e.astype(np.int32) << 16)
             | (pp_idx_e << 8)
             | flags_e.astype(np.int32))
    meta = ((coverage[level_pos].astype(np.int32) << 8)
            | ((vslot + 1) << 2)
            | (is_d0.astype(np.int32) << 1))
    return DenseWindow(
        ent_lvl=lvl_e, ent_b=b_e.astype(np.int8),
        ent_slot=slot_sorted.astype(np.int8), ent_A=ent_A,
        ent_M=match_e.astype(np.int64).astype(np.int32),
        ent_same=~d0_e & ~head_e, meta=meta, eorder=eorder,
        level_pos=level_pos, n_levels=Lt, Vb=Vb, E=E,
        edges=edges, length=length)



# ---------------------------------------------------------------------------
# device scan
# ---------------------------------------------------------------------------
#
# Packed level layout (fields packed into int32 words, slots flattened):
#   A[l, c*E+e] = (link << 16) | (pp_idx << 8) | flags
#   M[l, c*E+e] = match bits (bit n set: pred slot n matches our ppp)
#   meta[l]     = (cov << 8) | ((vslot + 1) << 2) | (is_d0 << 1) | is_pad
# The plain scan walks T levels per step (chunking amortizes per-step
# overhead).

import os as _os

LEVELS_PER_STEP = int(_os.environ.get("NPT_DP_LEVELS_PER_STEP", "8"))


def _dp_level(carry, A, M, meta, *, E, Vb, rt_id, cov_coef):
    """One level.  carry = (prev [6,E], bnd [Vb*6,E]); returns ys
    (best [6] int8, sc_bm [6] int32)."""
    import jax
    import jax.numpy as jnp

    prev, bnd = carry
    link = (A >> 16).reshape(6, E)
    pp_idx = ((A >> 8) & 0xFF).reshape(6, E)
    flags = (A & 0xFF).reshape(6, E)
    match = M.reshape(6, E)
    cov = meta >> 8
    vslot = ((meta >> 2) & 0x3F) - 1
    is_d0 = ((meta >> 1) & 1) != 0
    is_pad = (meta & 1) != 0

    valid = (flags & F_VALID) != 0
    is_head = (flags & F_HEAD) != 0
    cond1a = (flags & F_COND1A) != 0
    cond2b = (flags & F_COND2B) != 0
    ppb_ng = (flags & F_PPB_NOT_GAP) != 0

    w = 10 * link - cov_coef * cov

    # gather sources: boundary ring (d0 entries) ++ previous level (chains)
    src = jnp.concatenate([bnd, prev], axis=0)
    pred = src[pp_idx]  # [6,E,E]
    mbits = ((match[..., None] >> jnp.arange(E, dtype=jnp.int32)) & 1) != 0
    cand = jnp.where(mbits, pred, NEG)
    n_best = cand.max(axis=-1)
    # last matching slot (highest index) — insertion order
    slot_ids = jnp.arange(E, dtype=jnp.int32)
    last_slot = jnp.where(mbits, slot_ids, -1).max(axis=-1)
    n_last = jnp.take_along_axis(
        pred, jnp.maximum(last_slot, 0)[..., None], axis=-1)[..., 0]
    has_match = n_best > NEG // 2

    sc = jnp.where(
        is_head, w,
        jnp.where(has_match, jnp.maximum(n_best + w, 0), 0))
    sc = jnp.where(valid, sc, NEG)

    # ---- winning-entry selection, unrolled over slots ------------------
    bm = jnp.zeros(6, dtype=jnp.int32)
    sc_bm = sc[:, 0]
    link_bm = link[:, 0]
    p_pp = jnp.full(6, NEGINIT, dtype=jnp.int32)
    raiser = jnp.full(6, NEGINIT, dtype=jnp.int32)
    if rt_id == 0:  # ont: tmp = max link over entries
        tmp = jnp.where(valid, link, 0).max(axis=-1)
    for e in range(E):
        v = valid[:, e]
        hm = v & ~is_head[:, e] & has_match[:, e]
        sc_e = sc[:, e]
        raiser = jnp.where(v & (sc_e > 0), n_best[:, e], raiser)
        if rt_id in (1, 3):  # clr / hifi
            upd = hm & ((n_best[:, e] > p_pp)
                        | ((n_best[:, e] == p_pp) & ppb_ng[:, e]))
            bm = jnp.where(upd, e, bm)
            sc_bm = jnp.where(upd, sc_e, sc_bm)
            link_bm = jnp.where(upd, link[:, e], link_bm)
            p_pp = jnp.where(upd, n_best[:, e], p_pp)
        elif rt_id == 0:  # ont
            c1 = hm & cond1a[:, e] & (
                (5 * link[:, e] > cov) | (link[:, e] > tmp // 2))
            c2 = ~c1 & hm & (link[:, e] > link_bm // 2) \
                & (n_best[:, e] > p_pp) & cond2b[:, e]
            upd = c1 | c2
            bm = jnp.where(upd, e, bm)
            sc_bm = jnp.where(upd, sc_e, sc_bm)
            link_bm = jnp.where(upd, link[:, e], link_bm)
            p_pp = jnp.where(c1, n_last[:, e],
                             jnp.where(c2, n_best[:, e], p_pp))
        # common final rule
        if rt_id == 2:  # rs
            upd = v & (sc_e >= sc_bm)
        else:
            upd = v & ((sc_e > sc_bm) | ((sc_e == sc_bm) & ppb_ng[:, e]))
        bm = jnp.where(upd, e, bm)
        sc_bm = jnp.where(upd, sc_e, sc_bm)
        link_bm = jnp.where(upd, link[:, e], link_bm)
        p_pp = jnp.where(upd, raiser, p_pp)

    # carry updates (pad levels leave everything untouched)
    prev_out = jnp.where(is_pad, prev, sc)
    vs = jnp.maximum(vslot, 0)
    bnd_rot = jnp.where(is_d0 & ~is_pad, jnp.full_like(bnd, NEG), bnd)
    bnd_upd = jax.lax.dynamic_update_slice(bnd_rot, sc, (vs * 6, 0))
    bnd_out = jnp.where(is_pad | (vslot < 0), bnd_rot, bnd_upd)
    return (prev_out, bnd_out), (bm.astype(jnp.int8), sc_bm)


def _scan_packed(A, M, meta, *, E, Vb, rt_id, cov_coef):
    """A/M: [Lc, T, 6E]; meta: [Lc, T] — one window."""
    import jax
    import jax.numpy as jnp

    T = A.shape[1]

    def step(carry, xs):
        Ac, Mc, mc = xs
        ys = []
        for t in range(T):
            carry, y = _dp_level(carry, Ac[t], Mc[t], mc[t], E=E, Vb=Vb,
                                 rt_id=rt_id, cov_coef=cov_coef)
            ys.append(y)
        best = jnp.stack([y[0] for y in ys])
        sc = jnp.stack([y[1] for y in ys])
        return carry, (best, sc)

    init = (jnp.full((6, E), NEG, jnp.int32),
            jnp.full((Vb * 6, E), NEG, jnp.int32))
    _, (best, sc_bm) = jax.lax.scan(step, init, (A, M, meta))
    return (best.reshape(-1, 6), sc_bm.reshape(-1, 6))


B_MAX = 8  # windows per launch (one kernel program each)
E_BUCKETS = (16, 24)  # entry-slot buckets: Ep = 16 / 32 kernel lanes
VB_BUCKETS = (8, 24)  # boundary-ring buckets (MAX_VB = 24)


def size_bucket(n: int) -> int:
    """Smallest {1, 1.25, 1.5, 1.75} x pow2 >= n: padded sizes stay within
    ~25% while jit shape variants stay a small set."""
    n = max(n, 1)
    p = 1
    while True:
        for m in (4, 5, 6, 7):
            c = p * m // 4
            if c >= n:
                return c
        p *= 2


def _use_kernel() -> bool:
    """True on the GPU backend (the Triton level-scan kernel), False on
    the CPU backend (the plain lax.scan).  Any other platform raises."""
    import jax

    platform = jax.default_backend()
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise RuntimeError(
        f"engine-2 device scan: unsupported platform {platform!r}")


@dataclass
class Packed:
    """Host-packed launch inputs for B windows: compact per-entry streams
    (scattered into dense [B, NCL, 8, Ep] slabs on device) + level meta."""

    lvl: np.ndarray  # int32 [B, P] level of each entry (pad: NCL, dropped)
    col: np.ndarray  # int32 [B, P] cell * Ep + slot
    A: np.ndarray  # int32 [B, P]
    M: np.ndarray  # int32 [B, P]
    meta: np.ndarray  # int32 [B, NCL] (levels past a window: pad bit)
    nlev: np.ndarray  # int32 [B]
    Lts: list
    E: int
    Vb: int
    NCL: int

    def args(self):
        return (self.lvl, self.col, self.A, self.M, self.meta, self.nlev)


def pack_group(chunk, B: int | None = None, E: int = 0, Vb: int = 0
               ) -> Packed:
    """Pack up to B windows (default: the next power of two of the chunk
    size) into the (E, Vb) bucket that fits them all; `E`/`Vb` raise the
    bucket floor (tests and the smoke check exercise every bucket)."""
    from .pallas_scan import pow2

    E = min(x for x in E_BUCKETS if x >= max([E] + [dw.E for dw in chunk]))
    Vb = min(x for x in VB_BUCKETS
             if x >= max([Vb] + [dw.Vb for dw in chunk]))
    B = B or pow2(len(chunk))
    Ep = pow2(E)
    Lts = [dw.n_levels for dw in chunk]
    T = LEVELS_PER_STEP
    NCL = -(-size_bucket(max(Lts)) // T) * T
    P = size_bucket(max(len(dw.ent_b) for dw in chunk))
    lvl = np.full((B, P), NCL, dtype=np.int32)
    col = np.zeros((B, P), dtype=np.int32)
    A = np.zeros((B, P), dtype=np.int32)
    M = np.zeros((B, P), dtype=np.int32)
    meta = np.ones((B, NCL), dtype=np.int32)  # pad bit set
    nlev = np.zeros(B, dtype=np.int32)
    for i, dw in enumerate(chunk):
        n = len(dw.ent_b)
        a = dw.ent_A
        if Vb != dw.Vb:
            # re-base same-position pred indices past the wider ring
            a = a + (dw.ent_same.astype(np.int32) * ((Vb - dw.Vb) * 6)
                     << 8)
        lvl[i, :n] = dw.ent_lvl
        col[i, :n] = dw.ent_b.astype(np.int32) * Ep + dw.ent_slot
        A[i, :n] = a
        M[i, :n] = dw.ent_M
        meta[i, :Lts[i]] = dw.meta
        nlev[i] = Lts[i]
    return Packed(lvl, col, A, M, meta, nlev, Lts, E, Vb, NCL)


_FNS = {}


def get_scan(kernel: bool, E, Vb, rt_id, cov_coef, B, NCL, P):
    """Jitted launch f(*Packed.args()) -> (best int8, sc int32) [B, NCL, 6]
    for one shape bucket: the device-side slab scatter, then the Pallas
    kernel (`kernel`) or the plain chunked lax.scan."""
    import jax
    import jax.numpy as jnp

    from .pallas_scan import CELLS, level_scan_call, pow2

    platform = jax.default_backend()
    key = (kernel, platform, E, Vb, rt_id, cov_coef, B, NCL, P)
    fn = _FNS.get(key)
    if fn is not None:
        return fn
    Ep = pow2(E)
    T = LEVELS_PER_STEP
    if kernel:
        call = level_scan_call(E, Vb, rt_id, cov_coef, B, NCL, platform)
    else:
        scan = jax.vmap(partial(_scan_packed, E=E, Vb=Vb, rt_id=rt_id,
                                cov_coef=cov_coef))

    def run(lvl, col, A, M, meta, nlev):
        bi = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None],
                              lvl.shape)
        z = jnp.zeros((B, NCL, CELLS * Ep), jnp.int32)
        As = z.at[bi, lvl, col].set(A, mode="drop")
        Ms = z.at[bi, lvl, col].set(M, mode="drop")
        As = As.reshape(B, NCL, CELLS, Ep)
        Ms = Ms.reshape(B, NCL, CELLS, Ep)
        if kernel:
            best, sc = call(As, Ms, meta, nlev)
            return best[:, :, :6].astype(jnp.int8), sc[:, :, :6]

        def lanes(x):
            return x[:, :, :6, :E].reshape(B, NCL // T, T, 6 * E)

        best, sc = scan(lanes(As), lanes(Ms), meta.reshape(B, NCL // T, T))
        return best.reshape(B, NCL, 6), sc.reshape(B, NCL, 6)

    fn = jax.jit(run)
    _FNS[key] = fn
    return fn


def _dispatch_batch(dws, read_type, cov_coef=None, kernel=None,
                    E=0, Vb=0, devices=None):
    """Pack + launch the windows' scans, B_MAX windows per launch (async);
    returns pending handles for _collect_batch.  `kernel` defaults to the
    backend's route (_use_kernel); window groups round-robin over
    `devices` (default runtime.devices.compute_devices)."""
    import jax

    from ...runtime import trace
    from ...runtime.devices import compute_devices

    if kernel is None:
        kernel = _use_kernel()
    # window-group parallelism: round-robin groups over the local devices
    # (windows are the reference's batch axis, lib/ctg_cns.c:3455-3594;
    # devices take the place of worker processes)
    devices = devices or compute_devices()
    rt_id = READ_TYPE_ID[read_type]
    c = COV_COEF[read_type] if cov_coef is None else cov_coef
    pend = []
    for gi, glo in enumerate(range(0, len(dws), B_MAX)):
        pk = pack_group(dws[glo:glo + B_MAX], E=E, Vb=Vb)
        B, P = pk.lvl.shape
        fn = get_scan(kernel, pk.E, pk.Vb, rt_id, c, B, pk.NCL, P)
        args = jax.device_put(pk.args(), devices[gi % len(devices)])
        trace.count("cns.levels", max(pk.Lts))
        trace.count("cns.launches", 1)
        pend.append((pk.Lts, fn(*args)))
    return pend


def _collect_batch(pend):
    """Fetch pending launches -> per-window (best [Lt,6], sc_bm [Lt,6])."""
    out = []
    for Lts, (best_d, sc_d) in pend:
        best = np.asarray(best_d)
        sc = np.asarray(sc_d)
        out.extend((best[i, :Lt], sc[i, :Lt]) for i, Lt in enumerate(Lts))
    return out


def _run_batch(dws, read_type, cov_coef=None, mesh=None, kernel=None,
               E=0, Vb=0):
    """Run the scan over a batch of DenseWindows; returns per-window
    (best [Lt,6], sc_bm [Lt,6]) numpy arrays.  With `mesh`, the window
    axis of one plain-scan launch is sharded over every mesh axis (window
    data parallelism — blc_genome's contig blocks)."""
    if mesh is None:
        return _collect_batch(_dispatch_batch(dws, read_type, cov_coef,
                                              kernel, E, Vb))
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .pallas_scan import pow2

    nd = int(np.prod(list(mesh.shape.values())))
    pk = pack_group(dws, B=max(pow2(len(dws)), nd), E=E, Vb=Vb)
    c = COV_COEF[read_type] if cov_coef is None else cov_coef
    B, Pn = pk.lvl.shape
    fn = get_scan(False, pk.E, pk.Vb, READ_TYPE_ID[read_type], c, B,
                  pk.NCL, Pn)
    sh = NamedSharding(mesh, P(mesh.axis_names))
    best, sc = fn(*(jax.device_put(x, sh) for x in pk.args()))
    return _collect_batch([(pk.Lts, (best, sc))])


def device_link_dp(dw: DenseWindow, read_type: str,
                   cov_coef: int | None = None):
    """Single-window scan; returns (score_arr, best_arr) shaped like
    dp.link_dp's outputs so dp.traceback can be reused."""
    (out,) = _run_batch([dw], read_type, cov_coef)
    return _to_edge_outputs(dw, out[0], out[1])


def _to_edge_outputs(dw: DenseWindow, best: np.ndarray, sc_bm: np.ndarray):
    """Map per-level winners back to per-tag arrays on the EdgeTable.
    Entries are tag-major with slots ascending, so a tag's winning entry
    is eorder[tag_off[t] + best_slot[t]]."""
    edges = dw.edges
    Tn = len(edges.tag_key)
    tp, td, tb = unpack_keys(edges.tag_key)
    lvl_key = edges.tag_key >> 3
    new_lvl = np.ones(Tn, dtype=bool)
    new_lvl[1:] = lvl_key[1:] != lvl_key[:-1]
    lvl_of_tag = np.cumsum(new_lvl) - 1
    b_of_tag = tb.astype(np.int64)
    best_slot = best[lvl_of_tag, b_of_tag].astype(np.int64)
    best_arr = dw.eorder[edges.tag_off[:-1] + best_slot]
    score_arr = np.full(len(edges.cur), NEG, dtype=np.int64)
    score_arr[best_arr] = sc_bm[lvl_of_tag, b_of_tag]
    return score_arr, best_arr


def prepare_window(merged, coverage, length):
    """TagColumns -> (EdgeTable, DenseWindow | None), via the native
    single-pass builder (cns_prep.cpp) when available; the numpy
    build_edges + densify_window pair is the fallback and the oracle the
    native path is tested against."""
    from ... import native

    if native.available():
        cov = np.ascontiguousarray(coverage, dtype=np.int32)
        out = native.cns_prepare(merged.t_pos, merged.delta, merged.q_base,
                                 merged.row_off, cov, length, MAX_E, MAX_VB)
        if out is not None:
            ed, dn = out
            edges = EdgeTable(ed["cur"], ed["pp"], ed["ppp"], ed["link"],
                              ed["ins"], ed["tag_key"], ed["tag_off"])
            dw = None
            if dn is not None:
                dw = DenseWindow(
                    ent_lvl=dn["ent_lvl"], ent_b=dn["ent_b"],
                    ent_slot=dn["ent_slot"], ent_A=dn["ent_A"],
                    ent_M=dn["ent_M"], ent_same=dn["ent_same"],
                    meta=dn["meta"], eorder=dn["eorder"],
                    level_pos=dn["level_pos"], n_levels=dn["n_levels"],
                    Vb=dn["Vb"], E=dn["E"], edges=edges, length=length)
            return edges, dw
    edges = build_edges(merged)
    return edges, densify_window(edges, coverage, length)


def cns_dp_device(merged, coverage, length, read_type, min_cov, lq_min_qv):
    """Device counterpart of native.cns_dp: TagColumns -> Consensus, or
    None when the window exceeds the device caps."""
    edges, dw = prepare_window(merged, coverage, length)
    if dw is None:
        return None
    score, best = device_link_dp(dw, read_type)
    return traceback(edges, score, best, coverage, length, read_type,
                     min_cov, lq_min_qv=lq_min_qv)


def cns_dp_device_batch_begin(items, read_type):
    """Prepare + dispatch a batch of windows; the device scans run while
    the caller preps the next group.  Returns an opaque state for
    cns_dp_device_batch_end."""
    denses = []
    metas = []
    for merged, coverage, length in items:
        edges, dw = prepare_window(merged, coverage, length)
        denses.append(dw)
        metas.append((edges, coverage, length))
    todo = [i for i, dw in enumerate(denses) if dw is not None]
    pend = (_dispatch_batch([denses[i] for i in todo], read_type)
            if todo else [])
    return denses, metas, todo, pend, read_type


def cns_dp_device_batch_end(state, min_cov, lq_min_qv):
    """Collect a cns_dp_device_batch_begin state -> [Consensus | None]."""
    denses, metas, todo, pend, read_type = state
    out = [None] * len(denses)
    for i, (best, sc_bm) in zip(todo, _collect_batch(pend)):
        dw = denses[i]
        edges, coverage, length = metas[i]
        score, barr = _to_edge_outputs(dw, best, sc_bm)
        out[i] = traceback(edges, score, barr, coverage, length,
                           read_type, min_cov, lq_min_qv=lq_min_qv)
    return out


def cns_dp_device_batch(items, read_type, min_cov, lq_min_qv):
    """Batched windows -> [Consensus | None]; items are
    (merged_TagColumns, coverage, length) triples.  Windows that exceed
    the device caps come back as None (caller falls back per window)."""
    return cns_dp_device_batch_end(
        cns_dp_device_batch_begin(items, read_type), min_cov, lq_min_qv)
