"""Device classification programs.

The host ships exactly TWO 1D blobs — one int32, one float64 — per
chunk, and the results come back as one small array, so a chunk costs
one upload of each blob and one host synchronisation.

``classify_batch_dev`` runs the whole classification as ONE program
per sub-batch: merged forward+backward reliable-interval DP
(class_rel.c:623-963) with conditional rescue re-run, demotion
heuristics and fw/bw reconciliation, then both unreliable-relaxation
sweeps (class_unrel.c:248-300).  (A two-phase variant that synced
mid-chunk to let the host drop the relaxation steps of rel intervals
fixed at H/D — provable no-ops, class_unrel.c:265-273 — was tried on
the first target and dropped: the extra round trip cost more than the
dropped steps saved.)

Blob layouts (sizes static per jit specialisation):

  iblob (int32): b,e,cb,ce,ccb,cce,idx_desc,idx_asc,is_rel,live
                 [10 x Bn*max_n] | n [Bn] |
                 bpos,bcnt,epos,ecnt,max_cc [5 x R2*max_m] |
                 rel_cols [R*max_m] | m,plen,fwd [3 x R2] | rel_rows [R]
  fblob (f64):   pe,peob,peoe,lf_cb,lf_ce [5 x Bn*max_n] |
                 pe_rel,lf_bcnt,lf_ecnt [3 x R2*max_m]

(log-factorial planes are host table lookups, not device gathers.)
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from classpro_tpu.estimation import GlobalModel
from classpro_tpu.tpu.rel_dev2 import RelParams2, rel_dp_pass2
from classpro_tpu.tpu.skellam_dev import PackedSkellam, build_packed_skellam

# CP_ABLATE=stage,stage,...: MEASUREMENT-ONLY program ablations used to
# attribute device-program cost on the device (output is wrong with
# any stage listed; never set in production).  Stages: "norescue"
# (skip the conditional second DP pass), "notb" (skip the traceback
# loop, rel_dev2), "nodp" (skip the DP while_loop, rel_dev2).
import os as _os

_ABLATE = frozenset(
    s for s in _os.environ.get("CP_ABLATE", "").split(",") if s)
from classpro_tpu.tpu.unrel_dev2 import UnrelParams2, unrel_sweeps2

ERROR, REPEAT, HAPLO, DIPLO, N_STATE = 0, 1, 2, 3, 4
NEG_INF = float("-inf")


class PipelineParams(NamedTuple):
    rel: RelParams2
    unrel: UnrelParams2
    gcov: jnp.ndarray      # (4,) int64 global coverages (E, R, H, D)


class RelOnlyParams(NamedTuple):
    """The PipelineParams subset the rel-only program reads (.rel and
    .gcov).  The engine passes THIS to rel_only_dev so the AOT
    executable's signature excludes the unrel tables, whose shapes are
    dataset-dependent (btg_flat) — with them in the signature every
    dataset would fragment the process-global executable cache and
    compile again (engine._AOT_CACHE)."""
    rel: RelParams2
    gcov: jnp.ndarray


def build_pipeline_params(gm: GlobalModel) -> PipelineParams:
    from classpro_tpu.numerics import LOGFACT
    from classpro_tpu.tpu.tables import build_tables

    tab, lf385 = build_packed_skellam()
    ps = PackedSkellam(tab=jnp.asarray(tab), lf_n=jnp.asarray(lf385))
    d = gm.defaults
    cov_r = int(gm.cov[REPEAT])
    n1 = ((2 * cov_r + 6 + 127) // 128) * 128   # covers strc and DR*dl
    lf_small = jnp.asarray(LOGFACT[:n1])
    rel = RelParams2(
        ps=ps, logfact=jnp.asarray(LOGFACT), lf_small=lf_small,
        read_len=float(gm.read_len), offset=d.offset, r_logp=d.r_logp,
        e_po_base=d.e_po_base, log_1m_pe_mean=math.log(1 - d.pe_mean),
        log_pe_mean=math.log(d.pe_mean), dr_ratio=gm.dr_ratio)
    dt = build_tables(gm)
    btg_flat = jnp.asarray(dt.btg_log()[dt.unrel_idx].reshape(-1))
    unrel = UnrelParams2(
        ps=ps, lf_small=lf_small, btg_flat=btg_flat, n_cap=dt.n_cap,
        read_len=float(gm.read_len), r_logp=d.r_logp,
        log_1m_pe_mean=math.log(1 - d.pe_mean),
        log_pe_mean=math.log(d.pe_mean), dr_ratio=gm.dr_ratio,
        cov_r=cov_r, cov_h=int(gm.cov[HAPLO]), cov_d=int(gm.cov[DIPLO]))
    return PipelineParams(rel=rel, unrel=unrel,
                          gcov=jnp.asarray(np.asarray(gm.cov, np.int64)))


def _first_true(mask):
    return jnp.argmax(mask, axis=1), jnp.any(mask, axis=1)


def _oh_extract(arr, idx):
    """arr[b, idx[b]] via one-hot sum (idx may be garbage where unused)."""
    cols = jnp.arange(arr.shape[1])[None, :]
    oh = cols == idx[:, None]
    if arr.dtype == bool:
        return jnp.any(oh & arr, axis=1)
    return jnp.sum(jnp.where(oh, arr, 0), axis=1)


def _unpack(fblob, iblob, Bn, max_n, R2, max_m):
    """Blob views (XLA dead-code-eliminates whatever a caller skips)."""
    R = R2 // 2
    un_sz, rel_sz = Bn * max_n, R2 * max_m
    U = {}
    o = 0
    for k in ("b", "e", "cb", "ce", "ccb", "cce", "idx_desc", "idx_asc",
              "is_rel", "live"):
        U[k] = iblob[o:o + un_sz].reshape(Bn, max_n)
        o += un_sz
    U["n"] = iblob[o:o + Bn]
    o += Bn
    for k in ("bpos", "bcnt", "epos", "ecnt", "max_cc"):
        U[k] = iblob[o:o + rel_sz].reshape(R2, max_m).astype(jnp.int64)
        o += rel_sz
    U["rel_cols"] = iblob[o:o + R * max_m].reshape(R, max_m)
    o += R * max_m
    for k in ("m", "plen"):
        U[k] = iblob[o:o + R2].astype(jnp.int64)
        o += R2
    U["fwd"] = iblob[o:o + R2] != 0
    o += R2
    U["rel_rows"] = iblob[o:o + R]

    of = 0
    for k in ("pe", "peob", "peoe", "lf_cb", "lf_ce"):
        U[k] = fblob[of:of + un_sz].reshape(Bn, max_n)
        of += un_sz
    for k in ("pe_rel", "lf_bcnt", "lf_ecnt"):
        U[k] = fblob[of:of + rel_sz].reshape(R2, max_m)
        of += rel_sz
    return U


def _rel_pipeline(U, PP: PipelineParams, R2: int, max_m: int,
                  demotes: bool = True):
    """DP + conditional rescue re-run (+ the post-rescue demotions when
    ``demotes``) -> per-direction assignments.

    The production path (rel_only_dev) passes demotes=False: the
    no-h2/all-H/70%-H demotions are pure integer reductions over data
    the host already holds, so they run on the host instead
    (demote_host below, exact int64, same arithmetic).  Only the rescue
    stays here: it gates a second DP pass, which must not cost a round
    trip.  The all-device
    fallback/mesh path keeps demotes=True."""
    P = PP.rel
    R = R2 // 2
    bpos, bcnt, epos, ecnt = U["bpos"], U["bcnt"], U["epos"], U["ecnt"]
    m, plen, fwd = U["m"], U["plen"], U["fwd"]
    covEf = PP.gcov[ERROR].astype(jnp.float64)
    logpE = jnp.maximum(
        (bcnt * jnp.log(covEf) - covEf - U["lf_bcnt"])
        + (ecnt * jnp.log(covEf) - covEf - U["lf_ecnt"]) + P.e_po_base,
        U["pe_rel"])

    gH = PP.gcov[HAPLO].astype(jnp.float64)
    gD = PP.gcov[DIPLO].astype(jnp.float64)
    cols = jnp.arange(max_m)[None, :]
    inb = cols < m[:, None]
    cov_t = jnp.broadcast_to(PP.gcov[None, :], (R2, 4))

    def dp(cov):
        a, _, mm = rel_dp_pass2(bpos, bcnt, epos, ecnt, U["max_cc"],
                                U["lf_bcnt"], logpE, m, plen,
                                fwd, cov, P, max_m)
        return a.astype(jnp.int32), mm

    asgn, mm1 = dp(cov_t)
    if "nopost" in _ABLATE:   # MEASUREMENT-ONLY: skip rescue/demotes
        return asgn, mm1, jnp.zeros((R2,), bool)
    l_arr = jnp.abs(epos - bpos) + 1        # interval lengths (invariant)

    # NOTE on comparisons: this backend's f64 division is NOT correctly
    # rounded (measured x/x = 1 - 128ulp on XLA:CPU), so every
    # mean-vs-threshold test below is done in exact int64
    # cross-multiplied form.  Bit-equivalent to the reference's double
    # `(double)csum/lsum` comparisons: csum <= 2^40 and lsum <= 2^17, so
    # a non-tie distance from any integer/half-integer boundary is
    # >= 0.5/lsum ~ 4e-6, far above the C division's <= 4e-12 rounding.
    gHi = cov_t[:, HAPLO].astype(jnp.int64)
    gDi = cov_t[:, DIPLO].astype(jnp.int64)

    # ---- no-H rescue (class_rel.c:630-672 / 744-784) -------------------
    # The whole predicate is packed into exactly two reductions: one
    # 3-plane sum (D-length sum, D-count sum, H presence) and one
    # keyed min whose value carries both the first-D column and its
    # entering count (col << 16 | bcnt; bcnt <= 32767 < 2^16 so the
    # column ordering is untouched).  The first D in scan order == the
    # reference's first (fw) / last (bw) D in original order; its scan
    # entering count bcnt equals the reference's ccb (fw) / cce (bw).
    dmask = inb & (asgn == DIPLO)
    sums = jnp.sum(jnp.stack([
        jnp.where(dmask, l_arr, 0),
        jnp.where(dmask, (bcnt + ecnt) * l_arr // 2, 0),
        (inb & (asgn == HAPLO)).astype(jnp.int64)]), axis=2)
    lsum, csum, n_h1 = sums[0], sums[1], sums[2]
    no_h = n_h1 == 0
    key = jnp.min(jnp.where(dmask,
                            (cols.astype(jnp.int64) << 16) + bcnt,
                            jnp.int64(max_m) << 16), axis=1)
    has_d = key < (jnp.int64(max_m) << 16)
    anchor_cnt = key & 0xFFFF
    rescue = no_h & has_d & (csum < gDi * lsum)
    cov2 = cov_t.astype(jnp.int64)
    cov2 = cov2.at[:, HAPLO].set(
        jnp.where(rescue, anchor_cnt, cov2[:, HAPLO]))
    cov2 = cov2.at[:, DIPLO].set(
        jnp.where(rescue, anchor_cnt + PP.gcov[HAPLO], cov2[:, DIPLO]))
    if "norescue" in _ABLATE:   # MEASUREMENT-ONLY (CP_ABLATE)
        asgn2, mm2 = asgn, mm1
    else:
        asgn2, mm2 = jax.lax.cond(jnp.any(rescue),
                                  lambda: dp(cov2),
                                  lambda: (asgn, mm1))
    asgn = jnp.where(rescue[:, None], asgn2, asgn)
    # rescued rows' decisions came from BOTH passes (pass 1 triggered
    # the rescue); their guard margin is the min of the two
    rshape = rescue if mm1.ndim == 1 else rescue[:, None]
    mm = jnp.where(rshape, jnp.minimum(mm1, mm2), mm1)

    if demotes:
        asgn = _demotes_dev(asgn, rescue, inb, l_arr, bcnt, ecnt, m,
                            gHi, gDi)

    # Both direction rows, AFTER rescue (+ demotes when device-side);
    # bw rows in scan order.  The fw/bw reconciliation
    # (class_rel.c:847-938) happens on the HOST (reconcile_fwbw below):
    # its hdrr tie test |hdrr-1| <= |hdrr-1| sits exactly on the
    # comparison boundary for symmetric reads, and this backend's
    # non-correctly-rounded f64 division (x/x can be 1-128ulp) flips
    # such ties vs the reference's IEEE arithmetic.
    return asgn, mm, rescue   # (2R, max_m), (2R,) margins, (2R,) flags


def _demotes_dev(asgn, rescue, inb, l_arr, bcnt, ecnt, m, gHi, gDi):
    """Post-rescue demotions (class_rel.c:650-713), device version —
    used only by the all-device fallback/mesh path."""
    def dsum(a, state):
        mask = inb & (a == state)
        lsum = jnp.sum(jnp.where(mask, l_arr, 0), axis=1)
        csum = jnp.sum(jnp.where(mask, (bcnt + ecnt) * l_arr // 2, 0),
                       axis=1)
        return lsum, csum

    # second no-h check -> demote D to H (class_rel.c:650-669)
    no_h2 = rescue & ~jnp.any(inb & (asgn == HAPLO), axis=1)
    lsum2, csum2 = dsum(asgn, DIPLO)
    # lsum2 == 0 -> C's 0.0/0 mean is NaN and the fabs compare is false
    flip = no_h2 & (lsum2 > 0) & (jnp.abs(csum2 - gHi * lsum2)
                                  <= jnp.abs(csum2 - gDi * lsum2))
    asgn = jnp.where(flip[:, None] & (asgn == DIPLO), HAPLO, asgn)

    # ---- all-H -> maybe all-D (class_rel.c:674-690) ---------------------
    all_h = jnp.all(~inb | (asgn == HAPLO), axis=1)
    lsum_a = jnp.sum(jnp.where(inb, l_arr, 0), axis=1)
    csum_a = jnp.sum(jnp.where(inb, (bcnt + ecnt) * l_arr // 2, 0), axis=1)
    flip_all = all_h & (jnp.abs(csum_a - gHi * lsum_a)
                        >= jnp.abs(csum_a - gDi * lsum_a))
    asgn = jnp.where(flip_all[:, None] & inb,
                     jnp.where(asgn == HAPLO, DIPLO, asgn), asgn)

    # ---- >=70% H -> demote H->D, D->R (class_rel.c:692-713) -------------
    n_h = jnp.sum(inb & (asgn == HAPLO), axis=1)
    many_h = n_h >= m * 0.7
    lsum_h, csum_h = dsum(asgn, HAPLO)
    demote = many_h & (lsum_h > 0) & (jnp.abs(csum_h - gHi * lsum_h)
                                      >= jnp.abs(csum_h - gDi * lsum_h))
    asgn = jnp.where(demote[:, None] & (asgn == HAPLO) & inb, 100, asgn)
    asgn = jnp.where(demote[:, None] & (asgn == DIPLO) & inb, REPEAT, asgn)
    asgn = jnp.where(asgn == 100, DIPLO, asgn)
    return asgn


def demote_host(rel2: "np.ndarray", rescue: "np.ndarray",
                b: "np.ndarray", e: "np.ndarray", ccb: "np.ndarray",
                cce: "np.ndarray", m: "np.ndarray", gH: int,
                gD: int) -> "np.ndarray":
    """Post-rescue demotions (class_rel.c:650-713), host version — the
    production path.  Same exact-int64 arithmetic as _demotes_dev (the
    cross-multiplied mean-vs-threshold comparisons are bit-equivalent
    to the reference's double division, see the NOTE in _rel_pipeline),
    applied per scan-direction row to the raw device output before the
    fw/bw reconciliation.

    rel2: (2R, max_m) int8 (fw rows then bw rows in scan order);
    rescue: (2R,) bool no-H rescue flags from the device; b/e/ccb/cce:
    (R, max_m) forward-order interval bounds + corrected counts; m: (R,)
    live counts.  Returns the demoted copy (rel2 may be a read-only
    device-fetch view and is not mutated)."""
    import numpy as np

    R, max_m = b.shape
    mv = np.asarray(m, np.int64)
    cols = np.arange(max_m)[None, :]
    inb1 = cols < mv[:, None]
    inb = np.concatenate([inb1, inb1])
    m2 = np.concatenate([mv, mv])
    asgn = np.array(rel2, copy=True)   # int8 work copy (flips in place)
    gHi = np.int64(gH)
    gDi = np.int64(gD)

    # The demotion conditions gate on rare row properties (rescue flag,
    # all-H, >=70%-H), so the heavy int64 interval planes are built only
    # for CANDIDATE rows; the masks themselves are cheap int8/bool
    # passes.  Flips are applied in place between stages because each
    # stage's mask reads the PREVIOUS stage's result (a rescue-flipped
    # row can become all-H; an all-H-flipped row changes its H count) —
    # same sequencing as the reference's class_rel.c:650-713.
    def planes(rows):
        """l/bcnt/ecnt int64 planes (scan order) for 2R-row indices."""
        rr = rows % R
        bs = b[rr].astype(np.int64)
        es = e[rr].astype(np.int64)
        cbs = ccb[rr].astype(np.int64)
        ces = cce[rr].astype(np.int64)
        l = np.abs((es - 1) - bs) + 1
        bc, ec = cbs, ces
        bw = np.nonzero(rows >= R)[0]
        if bw.size:
            mvk = mv[rr[bw]]
            fi = np.where(cols < mvk[:, None], mvk[:, None] - 1 - cols,
                          cols)
            l[bw] = np.take_along_axis(l[bw], fi, axis=1)
            bc = bc.copy()
            ec = ec.copy()
            bc[bw] = np.take_along_axis(ces[bw], fi, axis=1)
            ec[bw] = np.take_along_axis(cbs[bw], fi, axis=1)
        return l, bc, ec

    # ---- no-H rescue rows: D -> H when the D-run mean sits nearer gH
    no_h2 = np.asarray(rescue, bool) & ~(inb & (asgn == HAPLO)).any(axis=1)
    rows = np.nonzero(no_h2)[0]
    if rows.size:
        l, bc, ec = planes(rows)
        mask = inb[rows] & (asgn[rows] == DIPLO)
        lsum = np.where(mask, l, 0).sum(axis=1)
        csum = np.where(mask, (bc + ec) * l // 2, 0).sum(axis=1)
        flip = (lsum > 0) & (np.abs(csum - gHi * lsum)
                             <= np.abs(csum - gDi * lsum))
        fr = rows[flip]
        sub = asgn[fr]
        asgn[fr] = np.where(sub == DIPLO, HAPLO, sub)

    # ---- all-H rows: H -> D when the row mean sits nearer (or tied) gD
    # (m2 == 0 padding rows are vacuously all-H but have no in-bounds
    # position to flip — the original applied a no-op; skip them)
    all_h = (~inb | (asgn == HAPLO)).all(axis=1) & (m2 > 0)
    rows = np.nonzero(all_h)[0]
    if rows.size:
        l, bc, ec = planes(rows)
        ib = inb[rows]
        lsum = np.where(ib, l, 0).sum(axis=1)
        csum = np.where(ib, (bc + ec) * l // 2, 0).sum(axis=1)
        flip = np.abs(csum - gHi * lsum) >= np.abs(csum - gDi * lsum)
        fr = rows[flip]
        sub = asgn[fr]
        asgn[fr] = np.where((sub == HAPLO) & inb[fr], DIPLO, sub)

    # ---- >=70%-H rows: demote H -> D and D -> R together
    n_h = (inb & (asgn == HAPLO)).sum(axis=1)
    many_h = (n_h >= m2 * 0.7) & (m2 > 0)   # 0 >= 0.0 is vacuous: no-op
    rows = np.nonzero(many_h)[0]
    if rows.size:
        l, bc, ec = planes(rows)
        mask = inb[rows] & (asgn[rows] == HAPLO)
        lsum = np.where(mask, l, 0).sum(axis=1)
        csum = np.where(mask, (bc + ec) * l // 2, 0).sum(axis=1)
        dem = (lsum > 0) & (np.abs(csum - gHi * lsum)
                            >= np.abs(csum - gDi * lsum))
        fr = rows[dem]
        sub = asgn[fr]
        ib = inb[fr]
        sub = np.where((sub == DIPLO) & ib, REPEAT,
                       np.where((sub == HAPLO) & ib, DIPLO, sub))
        asgn[fr] = sub
    return asgn.astype(rel2.dtype, copy=False)


def _reconcile_dev(asgn, m, bcnt, ecnt, fwd, R: int, max_m: int):
    """Device-side fw/bw reconciliation (class_rel.c:847-938) — used
    only by the all-device fallback/mesh path (classify_batch_dev).
    CAVEAT: hdrr uses this backend's approximate f64 division; an exact
    hdrr tie can resolve differently from the reference by ~1e-14 (the
    production engine reconciles on the host instead, IEEE-exact)."""
    cols = jnp.arange(max_m)[None, :]
    inb = cols < m[:, None]
    dm = inb & (asgn == DIPLO)
    hm = inb & (asgn == HAPLO)
    f_d, any_d = _first_true(dm)
    f_h, any_h = _first_true(hm)
    l_d = max_m - 1 - jnp.argmax(dm[:, ::-1], axis=1)
    l_h = max_m - 1 - jnp.argmax(hm[:, ::-1], axis=1)
    p = _oh_extract(bcnt, f_d).astype(jnp.float64) \
        / _oh_extract(bcnt, f_h).astype(jnp.float64)
    q = _oh_extract(ecnt, l_d).astype(jnp.float64) \
        / _oh_extract(ecnt, l_h).astype(jnp.float64)
    hdrr = jnp.where(any_d & any_h,
                     jnp.where(fwd, p / q, q / p), 1.0)

    asgn_f = asgn[:R]
    hdrr_f, hdrr_b = hdrr[:R], hdrr[R:]
    m_f = m[:R]
    inb_f = inb[:R]
    flip_idx = jnp.where(cols < m_f[:, None],
                         m_f[:, None] - 1 - cols, cols)
    asgn_b = jnp.take_along_axis(asgn[R:], flip_idx, axis=1)

    eq = jnp.all(~inb_f | (asgn_f == asgn_b), axis=1)
    nz = (asgn_f != 0) & inb_f

    def prefix_like(nzv, first_state):
        zmask = ~nzv & inb_f
        fz, has_z = _first_true(zmask)
        first_zero = jnp.where(has_z, fz, m_f)
        any_nz_after = jnp.any(nzv & (cols >= first_zero[:, None]), axis=1)
        return (first_state == REPEAT) & ~any_nz_after

    is_prefix = prefix_like(nz, asgn_f[:, 0])
    rev_nz = jnp.take_along_axis(nz, flip_idx, axis=1)
    lastv = _oh_extract(asgn_f, jnp.maximum(m_f - 1, 0))
    is_suffix = prefix_like(rev_nz, lastv)

    take_b = ~eq & ~is_prefix & (
        is_suffix | (jnp.abs(hdrr_f - 1.0) > jnp.abs(hdrr_b - 1.0)))
    return jnp.where(take_b[:, None], asgn_b, asgn_f)   # (R, max_m)


def reconcile_fwbw(rel2: "np.ndarray", ccb: "np.ndarray",
                   cce: "np.ndarray", m: "np.ndarray") -> "np.ndarray":
    """Host-side fw/bw reconciliation (class_rel.c:847-938), IEEE-exact.

    rel2: (2R, max_m) int8 device output (fw rows then bw rows, bw in
    scan order); ccb/cce: (R, max_m) int rel-interval corrected counts
    in forward order; m: (R,) live interval counts.  Returns the
    reconciled (R, max_m) forward-order assignment.

    Runs in numpy so the hdrr ratio test |hdrr_f-1| <= |hdrr_b-1| uses
    correctly-rounded doubles: an EXACT tie at 1.0 is the common case
    (symmetric reads) and must keep the forward pass, bit-for-bit as the
    reference does; the device backend's approximate f64 division breaks
    exactly that (see _reconcile_dev docstring)."""
    import numpy as np

    R = rel2.shape[0] // 2
    max_m = rel2.shape[1]
    out = rel2[:R].copy()
    # vectorized fast path: rows where fw == reversed-bw (the common
    # case) need no work; only disagreeing rows get the scalar treatment
    cols = np.arange(max_m)[None, :]
    mv = np.asarray(m)[:, None]
    flip = np.where(cols < mv, mv - 1 - cols, cols)
    bw_all = np.take_along_axis(rel2[R:], flip, axis=1)
    ineq = ((rel2[:R] != bw_all) & (cols < mv)).any(axis=1)
    for j in np.nonzero(ineq)[0]:
        mm = int(m[j])
        if mm <= 0:
            continue
        fw = rel2[j, :mm]
        bw = rel2[R + j, :mm][::-1]
        # is_eq_prefix / is_eq_suffix (class_rel.c:847-869)
        def pref(a):
            if a[0] != REPEAT:
                return False
            i = 0
            while i < mm and a[i]:
                i += 1
            return not a[i:].any()

        if pref(fw):
            continue
        if pref(fw[::-1]):
            out[j, :mm] = bw
            continue

        def hdrr_of(a):
            d = np.nonzero(a == DIPLO)[0]
            h = np.nonzero(a == HAPLO)[0]
            if len(d) == 0 or len(h) == 0:
                return 1.0
            return ((float(ccb[j, d[0]]) / float(ccb[j, h[0]]))
                    / (float(cce[j, d[-1]]) / float(cce[j, h[-1]])))

        if abs(hdrr_of(fw) - 1.0) <= abs(hdrr_of(bw) - 1.0):
            continue
        out[j, :mm] = bw
    return out


def _un_planes(U, PP: PipelineParams):
    """Derived per-interval planes for the relaxation (v1-kernel
    arithmetic: device log over the same logfact table values)."""
    P = PP.rel
    covHf = PP.gcov[HAPLO].astype(jnp.float64)
    covDf = PP.gcov[DIPLO].astype(jnp.float64)
    covEf = PP.gcov[ERROR].astype(jnp.float64)
    cb_u, ce_u = U["cb"], U["ce"]
    lf_cb, lf_ce = U["lf_cb"], U["lf_ce"]
    po_cb_e = cb_u * jnp.log(covEf) - covEf - lf_cb
    po_ce_e = ce_u * jnp.log(covEf) - covEf - lf_ce
    lE_u = jnp.maximum(U["pe"], po_cb_e + po_ce_e + P.e_po_base)
    f64 = jnp.float64

    def pois(k, lamf, lf_k):
        return k * jnp.log(lamf) - lamf - lf_k

    P13 = jnp.stack([
        cb_u.astype(f64), ce_u.astype(f64), lf_cb, lf_ce,
        U["b"].astype(f64), (U["e"] - 1).astype(f64), lE_u,
        pois(cb_u, covHf, lf_cb), pois(ce_u, covHf, lf_ce),
        pois(cb_u, covDf, lf_cb), pois(ce_u, covDf, lf_ce),
        U["peob"], U["peoe"]], axis=-1)
    packL = jnp.stack([U["cce"].astype(f64), (U["e"] - 1).astype(f64),
                       ce_u.astype(f64)], axis=-1)
    packR = jnp.stack([U["ccb"].astype(f64), U["b"].astype(f64),
                       cb_u.astype(f64)], axis=-1)
    return P13, packL, packR


def _rel_only_core(fblob, iblob, PP: PipelineParams, R: int, max_m: int):
    """Reliable-interval DP only (the production engine path: the
    branchy unreliable relaxation runs on the host in C++,
    csrc/classpro_host.cpp cp_unrel_batch).

    The host ships single-direction rel planes; both scan directions,
    the boundary-role stacking and the log-factorial lookups are derived
    here (transfer bandwidth is the scarce resource, device-side
    gathers outside loops are effectively free).

    iblob (int32): b,e,ccb,cce [4 x R*max_m] | m [R] | plen [R]
    fblob (f64):   pe [R*max_m]
    Returns (asgn (2R, max_m) int8 — fw rows then bw rows in scan
    order, post-rescue but PRE-demotion (the caller applies
    demote_host); margins (2R,) f64 — the exactness-guard min flip
    distance per row; rescue (2R,) bool no-H rescue flags, an input to
    demote_host).  The caller reconciles on the host (reconcile_fwbw, IEEE
    division) and host-recomputes rows whose margin is below epsilon
    with the exact oracle: the interpolated Skellam table (~1e-9) and
    this backend's non-IEEE division cannot flip a decision whose
    margin exceeds epsilon, and anything closer is decided by the same
    bit-exact arithmetic as the reference (fuzz seed 8339: an exact f64
    tie between two different expressions, resolved by C's
    first-wins order, is unreproducible from perturbed values).
    """
    sz = R * max_m
    if "echo" in _ABLATE:   # MEASUREMENT-ONLY: transfers + RTT only
        return (jnp.zeros((2 * R, max_m), jnp.int8)
                + iblob[0].astype(jnp.int8),
                jnp.zeros((2 * R,)) + fblob[0],
                jnp.zeros((2 * R,), bool))
    b = iblob[0:sz].reshape(R, max_m).astype(jnp.int64)
    e = iblob[sz:2 * sz].reshape(R, max_m).astype(jnp.int64)
    ccb = iblob[2 * sz:3 * sz].reshape(R, max_m).astype(jnp.int64)
    cce = iblob[3 * sz:4 * sz].reshape(R, max_m).astype(jnp.int64)
    m = iblob[4 * sz:4 * sz + R].astype(jnp.int64)
    plen = iblob[4 * sz + R:4 * sz + 2 * R].astype(jnp.int64)
    pe = fblob[0:sz].reshape(R, max_m)

    if "noprep" in _ABLATE:   # MEASUREMENT-ONLY: skip plane derivation
        z = jnp.zeros((2 * R, max_m), jnp.int64)
        U = {"bpos": z, "bcnt": z + 1, "epos": z, "ecnt": z + 1,
             "max_cc": z, "lf_bcnt": z.astype(jnp.float64),
             "lf_ecnt": z.astype(jnp.float64),
             "pe_rel": z.astype(jnp.float64),
             "m": jnp.concatenate([m, m]),
             "plen": jnp.concatenate([plen, plen]),
             "fwd": jnp.concatenate([jnp.ones(R, bool),
                                     jnp.zeros(R, bool)])}
        asgn, mm, rescue = _rel_pipeline(U, PP, 2 * R, max_m,
                                         demotes=False)
        return asgn.astype(jnp.int8), mm, rescue

    cols = jnp.arange(max_m)
    flip = jnp.where(cols[None, :] < m[:, None],
                     m[:, None] - 1 - cols[None, :], cols[None, :])

    # ONE reversal gather for all five int64 planes and one for pe: six
    # take_along_axis calls fused into two gather kernels
    max_cc = jnp.maximum(ccb, cce)
    stk = jnp.stack([e, cce, b, ccb, max_cc])            # (5, R, max_m)
    rstk = jnp.take_along_axis(stk, flip[None], axis=2)
    r_e, r_cce, r_b, r_ccb, r_max = (rstk[0], rstk[1], rstk[2],
                                     rstk[3], rstk[4])
    r_pe = jnp.take_along_axis(pe, flip, axis=1)
    lf = PP.rel.logfact
    bcnt = jnp.concatenate([ccb, r_cce])
    ecnt = jnp.concatenate([cce, r_ccb])
    # both logfact planes as one gather
    lf2 = lf[jnp.clip(jnp.stack([bcnt, ecnt]), 0, 32767)]
    U = {
        "bpos": jnp.concatenate([b, r_e - 1]),
        "bcnt": bcnt,
        "epos": jnp.concatenate([e - 1, r_b]),
        "ecnt": ecnt,
        "max_cc": jnp.concatenate([max_cc, r_max]),
        "lf_bcnt": lf2[0],
        "lf_ecnt": lf2[1],
        "pe_rel": jnp.concatenate([pe, r_pe]),
        "m": jnp.concatenate([m, m]),
        "plen": jnp.concatenate([plen, plen]),
        "fwd": jnp.concatenate([jnp.ones(R, bool), jnp.zeros(R, bool)]),
    }
    asgn, mm, rescue = _rel_pipeline(U, PP, 2 * R, max_m, demotes=False)
    return asgn.astype(jnp.int8), mm, rescue


# minimum decision margin below which a read's rel stage is recomputed
# on the host with exact arithmetic (the engine's exactness guard; see
# TpuEngine.REL_MARGIN_EPS for the error-budget derivation).  The
# risky-flag comparison runs HERE, on device, in f64 — the shipped f32
# margin is telemetry only.
REL_MARGIN_EPS = 1e-5


def _pack_out(asgn, mm, rescue, max_m: int):
    """Fuse the three rel outputs into ONE uint8 array (2R, max_m+5):
    [asgn bytes | flags (bit0 risky, bit1 rescue) | f32(margin) x4].

    One fused fetch is one host synchronisation per chunk instead of
    three."""
    risky = (mm > 0.0) & (mm < REL_MARGIN_EPS)          # f64, exact
    flags = risky.astype(jnp.uint8) | (rescue.astype(jnp.uint8) << 1)
    mm32 = jax.lax.bitcast_convert_type(
        mm.astype(jnp.float32), jnp.uint8)               # (2R, 4) LE
    return jnp.concatenate(
        [asgn.astype(jnp.uint8), flags[:, None], mm32], axis=1)


def unpack_out(buf, max_m: int):
    """Host-side split of _pack_out's blob: returns (asgn int8
    (2R, max_m), risky bool, rescue bool, margin f32 (2R,))."""
    import numpy as np

    buf = np.ascontiguousarray(buf)
    v = buf[:, :max_m].view(np.int8)
    flags = buf[:, max_m]
    mm = buf[:, max_m + 1: max_m + 5].copy().view(np.float32).ravel()
    return v, (flags & 1) != 0, (flags & 2) != 0, mm


@functools.partial(jax.jit, static_argnames=("R", "max_m"))
def rel_only_dev(fblob, iblob, PP: PipelineParams, R: int, max_m: int):
    asgn, mm, rescue = _rel_only_core(fblob, iblob, PP, R, max_m)
    return _pack_out(asgn, mm, rescue, max_m)


@functools.partial(jax.jit,
                   static_argnames=("Bn", "max_n", "R2", "max_m"))
def classify_batch_dev(fblob, iblob, PP: PipelineParams,
                       Bn: int, max_n: int, R2: int, max_m: int):
    """Single-program pipeline (no step compaction): used by the
    no-native fallback and the data-parallel mesh path.  Returns
    (final asgn (Bn, max_n) int8, flags (Bn,) bool — reads whose rel
    or relaxation decisions fell inside the exactness-guard epsilon;
    callers recompute those with the exact oracle)."""
    EPS = 1e-5   # matches TpuEngine.REL_MARGIN_EPS
    U = _unpack(fblob, iblob, Bn, max_n, R2, max_m)
    rel2, rel_mm, _rescue = _rel_pipeline(U, PP, R2, max_m)
    rel_out = _reconcile_dev(rel2, U["m"], U["bcnt"], U["ecnt"],
                             U["fwd"], R2 // 2, max_m)
    asgn_un = jnp.full((Bn, max_n), N_STATE, jnp.int32)
    asgn_un = asgn_un.at[
        U["rel_rows"][:, None], U["rel_cols"]].set(rel_out, mode="drop")
    P13, packL, packR = _un_planes(U, PP)
    undyn = {"is_rel": U["is_rel"] != 0, "asgn": asgn_un,
             "P13": P13, "packL": packL, "packR": packR}
    xs_desc = {"idx": U["idx_desc"], "live": U["live"] != 0}
    xs_asc = {"idx": U["idx_asc"], "live": U["live"] != 0}
    out, un_mm = unrel_sweeps2(undyn, xs_desc, xs_asc, U["n"],
                               PP.unrel, max_n)

    def risky(v):
        return (v > 0.0) & (v < EPS)

    R = R2 // 2
    rel_risky = risky(rel_mm[:R]) | risky(rel_mm[R:])
    f = risky(un_mm).astype(jnp.int32)
    f = f.at[U["rel_rows"]].max(rel_risky.astype(jnp.int32),
                                mode="drop")
    return out, f > 0
