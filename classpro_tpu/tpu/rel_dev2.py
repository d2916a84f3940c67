"""Batched reliable-interval DP on device, v2 (ref class_rel.c).

Design:

* the whole DP runs inside one device program (device_pipeline.py), so
  a chunk costs one host synchronisation;
* inside the loop, gathers are few: log-factorials at path-carried
  counts use exact one-hot selections and the traceback selects
  backpointers with a one-hot-of-4 sum;
* ``lanes`` can split the rows into independent carry chains inside
  ONE loop (production uses lanes=1).

Semantics vs the reference (byte-validated end to end):

* forward and backward passes (class_rel.c:623,737) run as one scan
  over merged rows with a per-row ``fwd`` flag (backward rows are
  index-reversed by the caller; direction only flips sign/role selects);
* all eight Skellam transition evaluations of a step run as one packed
  table call per lane;
* the reference's per-interval probability normalisation
  (class_rel.c:321-336) subtracts a per-row scalar from all 16 (s,t)
  entries and cannot change any later argmax/comparison, so the
  log-sum-exp is dropped; its two non-uniform special cases are kept,
  detected on raw values (psum underflow -> each (s, ERROR) entry gets
  prob 1/4; any lp == +inf -> that entry NaN, all others -inf);
* the O(M^2) backtrack copies (class_rel.c:401-407) become per-cell
  path registers updated in O(1): last-H/D (position, count), the
  H-before-D / D-before-H pair feeding calc_dh_ratio
  (class_rel.c:113-156), and has-H/has-D flags, packed into one int64
  and one bool tensor per lane.
"""

from __future__ import annotations

import functools

from typing import NamedTuple

import jax
import jax.numpy as jnp

from classpro_tpu.tpu.skellam_dev import (PackedSkellam, skellam_args,
                                          skellam_value)

ERROR, REPEAT, HAPLO, DIPLO, N_STATE = 0, 1, 2, 3, 4
NEG_INF = float("-inf")

# regs_i slot layout (int64, (B, 4 cells, 16))
_SP = 0          # 0:4   st_pos per slot (E,R,H,D)
_SC = 4          # 4:8   st_cnt per slot
_LH = 8          # 8:10  lastH (pos, cnt)
_LD = 10         # 10:12 lastD
_LHBD = 12       # 12:14 lastHbD
_LDBH = 14       # 14:16 lastDbH
# regs_b flag layout (bool, (B, 4 cells, 6))
_EXH, _EXD, _EXHBD, _EXDBH, _HASH, _HASD = range(6)


class RelParams2(NamedTuple):
    ps: PackedSkellam      # packed Skellam interpolation table
    logfact: jnp.ndarray   # (32768,) f64
    lf_small: jnp.ndarray  # (n1,) logfact head for one-hot R-binomial
    read_len: float
    offset: int
    r_logp: float
    e_po_base: float
    log_1m_pe_mean: float
    log_pe_mean: float
    dr_ratio: float


# Exactness guard (see tpu/device_pipeline.rel_only_dev): every argmax
# and int-truncation whose inputs pass through the interpolated Skellam
# table (error ~1e-9) or the backend's non-correctly-rounded division
# (~128 ulp) is margin-tracked; a row whose minimum margin falls below
# the engine's epsilon is recomputed on the host with exact arithmetic.
# Found by fuzz seed 8339: an EXACT f64 tie between two *different*
# expressions at a predecessor argmax — C resolves ties by order, and
# table-perturbed values broke the tie the other way.
TRUNC_EPS_NOTE = "int-trunc args are flagged via the same margin vector"

# CP_NO_GUARD=1: MEASUREMENT-ONLY kill switch for the exactness guard's
# device ops (margin tracking + correctly-rounded division) so their
# cost can be attributed on the device (VERDICT r2 #1).  Output is
# NOT byte-identity-safe with it set; never enable in production.
import os as _os

_NO_GUARD = _os.environ.get("CP_NO_GUARD") == "1"
_STUB_GATHER = _os.environ.get("CP_STUB_GATHER") == "1"
_ABLATE = frozenset(
    s for s in _os.environ.get("CP_ABLATE", "").split(",") if s)


# ---------------------------------------------------------------------
# Elementwise replacements for tiny-axis (size-4) reductions.  Inside
# the scan body a reduce/argmax can lower to its own kernel launch; a
# size-4 max/argmax as a maximum/where tree is pure elementwise work
# that fuses with its neighbours.
# Semantics match jnp.max/argmax bit-for-bit on non-NaN data (strict >
# keeps first-wins ties); NaN-poisoned rows can pick a different index
# than jnp.argmax (which treats NaN as maximal), but every NaN source
# in this scan (the has_inf +inf->NaN poisoning) also forces the row's
# guard margin to 1e-30, so such rows are host-recomputed exactly.


def _s4(x, axis):
    """The four static slices along a size-4 axis."""
    xs = jnp.moveaxis(x, axis, 0)
    return xs[0], xs[1], xs[2], xs[3]


def _emax4(x, axis):
    a, b, c, d = _s4(x, axis)
    return jnp.maximum(jnp.maximum(a, b), jnp.maximum(c, d))


def _emin4(x, axis):
    a, b, c, d = _s4(x, axis)
    return jnp.minimum(jnp.minimum(a, b), jnp.minimum(c, d))


def _emaxarg4(x, axis):
    """(max, first-wins argmax) along a size-4 axis, elementwise."""
    a, b, c, d = _s4(x, axis)
    v, i = a, jnp.zeros(a.shape, jnp.int32)
    for k, xk in ((1, b), (2, c), (3, d)):
        take = xk > v
        v = jnp.maximum(v, xk)          # NaN-propagating, like jnp.max
        i = jnp.where(take, k, i)
    return v, i


def _eany4(x, axis):
    a, b, c, d = _s4(x, axis)
    return (a | b) | (c | d)


def _eall4(x, axis):
    a, b, c, d = _s4(x, axis)
    return (a & b) & (c & d)


def _top2_margin(x, axis):
    """top1 - top2 along a size-4 ``axis``: the flip distance of that
    argmax.  +inf when fewer than two finite candidates (nothing to
    flip to); tiny positive when NaN-poisoned (conservative: always
    flag).  Elementwise (see the kernel-cost note above)."""
    if _NO_GUARD:
        return jnp.full(tuple(d for i, d in enumerate(x.shape)
                              if i != (axis % x.ndim)), jnp.inf)
    xs = _s4(x, axis)
    top1, am = _emaxarg4(x, axis)
    masked = [jnp.where(am == k, -jnp.inf, xk)
              for k, xk in enumerate(xs)]
    top2 = jnp.maximum(jnp.maximum(masked[0], masked[1]),
                       jnp.maximum(masked[2], masked[3]))
    mgn = top1 - top2
    mgn = jnp.where(jnp.isneginf(top2), jnp.inf, mgn)
    # margin EXACTLY 0 = bit-equal tie: both sides hold identical
    # doubles and resolve first-wins identically (safe, not flagged);
    # NaN-poisoned comparisons get a tiny positive margin (flagged)
    return jnp.where(jnp.isnan(mgn), 1e-30, mgn)


def _two_prod(a, b):
    """Dekker two-product: a*b = hi + lo EXACTLY, provided add/mul/sub
    are each correctly rounded and not contracted into FMAs (checked on
    the GPU by chip_smoke.py's div_cr phase)."""
    hi = a * b
    c = 134217729.0                 # 2^27 + 1 (Veltkamp split)
    a1 = a * c
    ah = a1 - (a1 - a)
    al = a - ah
    b1 = b * c
    bh = b1 - (b1 - b)
    bl = b - bh
    lo = ((ah * bh - hi) + ah * bl + al * bh) + al * bl
    return hi, lo


def _div_cr(a, b):
    """Correctly-rounded f64 division.  XLA's native divide was measured
    off by O(100) ulp on XLA:CPU (BASELINE_MEASURED.md: x/x = 1 - 128
    ulp), which breaks bit-parity wherever a quotient feeds an int
    truncation or an exact comparison (the reference's division is IEEE).
    One Newton step with an exact Dekker-product residual recovers the
    IEEE result (residual r = a - q*b is exact; q + r/b rounds to
    RN(a/b) whenever the native q is within ~2^40 ulp)."""
    if _NO_GUARD:
        return a / b
    q = a / b
    hi, lo = _two_prod(q, b)
    r = (a - hi) - lo
    out = q + r / b
    return jnp.where(jnp.isfinite(q), out, q)


def _lf_oh(idx, lf_small):
    """logfact[idx] by exact one-hot contraction (idx < lf_small.size)."""
    n1 = lf_small.shape[0]
    i = jnp.clip(idx, 0, n1 - 1)
    oh = jnp.arange(n1) == i[..., None]
    return jnp.sum(jnp.where(oh, lf_small, 0.0), axis=-1)


def _sel4(reg, sel):
    """reg[b, sel[b,t], ...] for sel (B,4): a where-chain over the 4
    predecessor cells (exact selection, pure elementwise — a one-hot
    sum is a reduce kernel per call inside the scan)."""
    selx = sel.reshape(sel.shape + (1,) * (reg.ndim - 2))       # (B,t,1..)
    r = [reg[:, k][:, None] for k in range(4)]                  # (B,1,...)
    return jnp.where(selx == 0, r[0],
                     jnp.where(selx == 1, r[1],
                               jnp.where(selx == 2, r[2], r[3])))


def _lane_init(L, P: RelParams2):
    """Initial DP cell (class_rel.c:544-595) for one lane's row dict."""
    B = L["bpos"].shape[0]
    cov, fwd = L["cov"], L["fwd"]
    OFF, covR, covH = L["OFF"], L["covR"], L["covH"]
    covHf = cov[:, HAPLO].astype(jnp.float64)
    covDf = cov[:, DIPLO].astype(jnp.float64)

    pos_init = jnp.where(fwd, -jnp.int64(P.offset),
                         L["plen"].astype(jnp.int64) + P.offset)
    bcnt0 = L["bcnt"][:, 0]
    ecnt0 = L["ecnt"][:, 0]
    epos0 = L["epos"][:, 0]
    lf_b0 = L["lf_bcnt"][:, 0]

    regs_i = jnp.zeros((B, 4, 16), jnp.int64)
    regs_i = regs_i.at[:, :, _SP:_SP + 4].set(pos_init[:, None, None])
    regs_i = regs_i.at[:, :, _SC:_SC + 4].set(
        cov[:, None, :].astype(jnp.int64))

    dpE = L["logpE"][:, 0]

    st_r_cnt = covR
    # one fused gather for both logfact reads (one kernel instead of
    # two)
    n1 = P.lf_small.shape[0]
    lf_pair0 = P.lf_small[jnp.clip(
        jnp.stack([st_r_cnt, st_r_cnt - bcnt0]), 0, n1 - 1)]
    lf_r, lf_rd = lf_pair0[0], lf_pair0[1]
    logp_er = jnp.where(
        bcnt0 < st_r_cnt,
        lf_r - lf_b0 - lf_rd + bcnt0 * P.log_1m_pe_mean
        + (st_r_cnt - bcnt0) * P.log_pe_mean, NEG_INF)
    max_cc0 = L["max_cc"][:, 0]
    dpR = jnp.where(
        logp_er > P.r_logp, logp_er,
        jnp.where((max_cc0 >= cov[:, REPEAT]) | (max_cc0 >= st_r_cnt),
                  P.r_logp, logp_er))
    regs_i = regs_i.at[:, REPEAT, _SP + REPEAT].set(epos0)
    regs_i = regs_i.at[:, REPEAT, _SC + REPEAT].set(
        jnp.minimum(ecnt0, covR))

    dpH = bcnt0 * jnp.log(covHf) - covHf - lf_b0
    regs_i = regs_i.at[:, HAPLO, _SP + HAPLO].set(epos0)
    regs_i = regs_i.at[:, HAPLO, _SC + HAPLO].set(ecnt0)
    regs_i = regs_i.at[:, HAPLO, _SP + DIPLO].set(epos0 - OFF)
    regs_i = regs_i.at[:, HAPLO, _SC + DIPLO].set(ecnt0 + covH)

    dpD = bcnt0 * jnp.log(covDf) - covDf - lf_b0
    regs_i = regs_i.at[:, DIPLO, _SP + HAPLO].set(epos0 - OFF)
    regs_i = regs_i.at[:, DIPLO, _SC + HAPLO].set(
        jnp.maximum(ecnt0 // 2, ecnt0 - covH))
    regs_i = regs_i.at[:, DIPLO, _SP + DIPLO].set(epos0)
    regs_i = regs_i.at[:, DIPLO, _SC + DIPLO].set(ecnt0)

    e2 = jnp.stack([epos0, ecnt0], axis=1)                        # (B, 2)
    regs_i = regs_i.at[:, HAPLO, _LH:_LH + 2].set(e2)
    regs_i = regs_i.at[:, DIPLO, _LD:_LD + 2].set(e2)

    regs_b = jnp.zeros((B, 4, 6), bool)
    regs_b = regs_b.at[:, HAPLO, _EXH].set(True)
    regs_b = regs_b.at[:, DIPLO, _EXD].set(True)
    regs_b = regs_b.at[:, HAPLO, _HASH].set(True)
    regs_b = regs_b.at[:, DIPLO, _HASD].set(True)

    dp0 = jnp.stack([dpE, dpR, dpH, dpD], axis=1)

    # class_rel.c init normalization (oracle _classify_rel_pass:
    # psum/exp block): a state whose softmax probability underflows to
    # EXACTLY 0.0 is DEAD (NEG_INF) at the init cell.  The raw-score
    # carry is argmax-invariant for the continuous comparisons, but
    # this kill is a DISCRETE semantic it must replicate: fuzz seed
    # 21517 left an ERROR state alive at -753 raw where the reference
    # had killed it, and the live pred flipped the backward pass's
    # only_r decision (a large-margin flip the guard cannot see).
    p0 = jnp.exp(dp0)
    psum0 = jnp.sum(p0, axis=1, keepdims=True)
    v0 = _div_cr(p0, psum0)
    dp0 = jnp.where(v0 > 0.0, dp0, NEG_INF)   # nan/0 -> dead, like C
    # exactness guard: the kill boundary is v == 0 at p/psum =
    # 2^-1075, i.e. dp - log(psum) = -745.1332; device exp/log/div
    # rounding (~1e-13 here) can only flip it within a whisker of
    # that line — flag such rows (and the degenerate all-dead /
    # overflow cases) for exact host recompute.
    t0 = dp0 - jnp.log(psum0)
    near = jnp.any(jnp.abs(t0 + 745.1332) < 0.1, axis=1)
    degen = (psum0[:, 0] == 0.0) | ~jnp.isfinite(psum0[:, 0])
    mm0 = jnp.where(near | degen, 1e-30, jnp.inf)  # running min margin

    dh0 = jnp.full((B, 4), NEG_INF)
    return (dp0, dh0, regs_i, regs_b, e2, mm0)


def _lane_step(carry, xs, consts, P: RelParams2):
    """One DP step (class_rel.c:279-513) for one lane."""
    dp, dh, regs_i, regs_b, eff, mmin = carry
    bpos_i, bcnt_i, epos_i, ecnt_i, max_cc_i, lf_b_i, logpE_i, i = xs
    cov, fwd = consts["cov"], consts["fwd"]
    OFF, PSTEP = consts["OFF"], consts["PSTEP"]
    covR, covH, m = consts["covR"], consts["covH"], consts["m"]
    B = dp.shape[0]
    iota4 = jnp.arange(4)[None, :]

    st_pos = regs_i[:, :, _SP:_SP + 4]
    st_cnt = regs_i[:, :, _SC:_SC + 4]

    logpE = jnp.broadcast_to(logpE_i[:, None], (B, 4))

    # R target emission (class_rel.c:172-211 via carried repeat count);
    # logfact reads as one small direct gather (cheaper than a 256-wide
    # f64 one-hot per step)
    strc = st_cnt[:, :, REPEAT]                              # (B, 4)
    n1 = P.lf_small.shape[0]
    idx_pair = jnp.clip(jnp.concatenate(
        [strc, strc - bcnt_i[:, None]], axis=1), 0, n1 - 1)
    lf_pair = P.lf_small[idx_pair]
    lf_strc, lf_sd = lf_pair[:, :4], lf_pair[:, 4:]
    logp_er_r = jnp.where(
        bcnt_i[:, None] < strc,
        lf_strc - lf_b_i[:, None] - lf_sd
        + bcnt_i[:, None] * P.log_1m_pe_mean
        + (strc - bcnt_i[:, None]) * P.log_pe_mean, NEG_INF)
    logpR = jnp.where(
        logp_er_r > P.r_logp, logp_er_r,
        jnp.where((max_cc_i[:, None] >= cov[:, REPEAT][:, None])
                  | (max_cc_i[:, None] >= strc),
                  P.r_logp, logp_er_r))

    # H/D targets: ONE batched Skellam call per lane
    sth_p = st_pos[:, :, HAPLO]
    sth_c = st_cnt[:, :, HAPLO]
    std_p = st_pos[:, :, DIPLO]
    std_c = st_cnt[:, :, DIPLO]
    use_ratio = dh != NEG_INF
    h_cb = jnp.where(use_ratio, std_c, sth_c)
    h_pos = jnp.where(use_ratio, std_p, sth_p)
    h_ce = jnp.where(use_ratio,
                     (dh * bcnt_i[:, None]).astype(jnp.int64),
                     bcnt_i[:, None])
    kH = h_ce - h_cb
    lamH = (h_cb.astype(jnp.float64)
            * jnp.abs(bpos_i[:, None] - (h_pos - PSTEP[:, None]))
            / P.read_len)
    kD = bcnt_i[:, None] - std_c
    lamD = (std_c.astype(jnp.float64)
            * jnp.abs(bpos_i[:, None] - (std_p - PSTEP[:, None]))
            / P.read_len)
    k_all = jnp.stack([kH, kD], axis=1)                      # (B, 2, 4)
    lam_all = jnp.stack([lamH, lamD], axis=1)
    n_, idx_, f_, in_a, x_, ka = skellam_args(k_all, lam_all)
    if _STUB_GATHER:
        # CP_STUB_GATHER=1: MEASUREMENT-ONLY — replace the packed-table
        # gather with a same-shape broadcast so its cost can be
        # attributed on the live chip.  Output is garbage; never use
        # outside profiling.
        nodes = jnp.broadcast_to(P.ps.tab[0, 0], n_.shape + (5,))
    else:
        nodes = P.ps.tab[n_, idx_]
    lp_hd = skellam_value(nodes, P.ps, n_, f_, in_a, x_, ka,
                          jnp.asarray(lam_all, jnp.float64))
    logpH, logpD = lp_hd[:, 0, :], lp_hd[:, 1, :]

    logp_st = jnp.stack([logpE, logpR, logpH, logpD], axis=2)
    # Normalisation dropped (argmax-invariant); C special cases kept:
    lp = jnp.where((dp == NEG_INF)[:, :, None], NEG_INF, logp_st)
    mx = _emax4(_emax4(lp, 2), 1)
    has_inf = jnp.isposinf(mx)
    zero = mx < -745.13  # C: psum == 0.0 (all exp underflow)
    logp_tr = jnp.where(
        has_inf[:, None, None],
        jnp.where(jnp.isposinf(lp), jnp.nan, NEG_INF), lp)
    logp_tr = jnp.where(
        zero[:, None, None],
        jnp.where(jnp.arange(4)[None, None, :] == ERROR,
                  jnp.log(0.25), NEG_INF), logp_tr)

    # C normalizes via exp(logp) (class_rel.c:321-336): ANY entry below
    # the exp-underflow cutoff is exactly dead there (exp -> 0.0 ->
    # log(0/psum) = -inf), not only all-16 rows.  Replicate the cut —
    # a raw -800 entry must not outlive entries C kills.  Just above
    # the cutoff C's exp() result is DENORMAL (raw < ~-708): its
    # quantization distorts C's comparison values by up to ~0.7 nats
    # near the cutoff, so rows with live entries in that band are
    # flagged for exact host recompute instead of certified by margin.
    m_band = jnp.where(
        _eany4(_eany4((logp_tr > -745.2) & (logp_tr < -719.0), 2), 1),
        1e-30, jnp.inf)
    logp_tr = jnp.where(logp_tr < -745.13, NEG_INF, logp_tr)

    # ---- only_r (class_rel.c:348-356)
    scores = dp[:, :, None] + logp_tr
    sc_best_t, best_t = _emaxarg4(scores, 2)
    dead_s = sc_best_t == NEG_INF
    only_r = _eall4(dead_s | (best_t == REPEAT), 1)
    # exactness guard: per s the only_r question is BINARY — does
    # REPEAT-or-dead beat every other target — and the reference breaks
    # at the first non-REPEAT row (class_rel.c:348-356), so only rows
    # whose predecessors all answered REPEAT/dead can flip the outcome.
    # (A near-tie between two non-REPEAT targets is irrelevant here; it
    # is guarded at the per-target pick below.)
    sc_rep = scores[:, :, REPEAT]
    sc_oth = _emax4(
        jnp.where(iota4[:, None, :] == REPEAT, NEG_INF, scores), 2)
    m_or = jnp.abs(sc_rep - sc_oth)
    m_or = jnp.where(jnp.isneginf(sc_rep) | jnp.isneginf(sc_oth),
                     jnp.inf, m_or)
    m_or = jnp.where(jnp.isnan(m_or), 1e-30, m_or)
    rep_s = dead_s | (best_t == REPEAT)
    p1 = rep_s[:, 0]
    p2 = p1 & rep_s[:, 1]
    prefix_ok = jnp.stack(
        [jnp.ones_like(p1), p1, p2, p2 & rep_s[:, 2]], axis=1)
    m_onlyr = _emin4(jnp.where(prefix_ok, m_or, jnp.inf), 1)

    # ---- HH/DD coupling (class_rel.c:383-386)
    colH = scores[:, :, HAPLO]
    colD = scores[:, :, DIPLO]
    vH, aH = _emaxarg4(colH, 1)
    vD, aD = _emaxarg4(colD, 1)
    maxs_h = jnp.where(vH == NEG_INF, N_STATE, aH)
    maxs_d = jnp.where(vD == NEG_INF, N_STATE, aD)
    couple = (maxs_h == HAPLO) & (maxs_d == DIPLO)
    # exactness guard: the coupling trigger asks only whether row
    # HAPLO tops colH and row DIPLO tops colD — binary margins
    def _bin_margin(col, idx):
        own = col[:, idx]
        oth = _emax4(jnp.where(jnp.arange(4)[None, :] == idx,
                               NEG_INF, col), 1)
        d = jnp.abs(own - oth)
        d = jnp.where(jnp.isneginf(own) | jnp.isneginf(oth), jnp.inf, d)
        return jnp.where(jnp.isnan(d), 1e-30, d)

    m_coup = jnp.minimum(_bin_margin(colH, HAPLO),
                         _bin_margin(colD, DIPLO))
    mcoup = jnp.minimum(logp_tr[:, HAPLO, HAPLO],
                        logp_tr[:, DIPLO, DIPLO])
    logp_tr = logp_tr.at[:, HAPLO, HAPLO].set(
        jnp.where(couple, mcoup, logp_tr[:, HAPLO, HAPLO]))
    logp_tr = logp_tr.at[:, DIPLO, DIPLO].set(
        jnp.where(couple, mcoup, logp_tr[:, DIPLO, DIPLO]))
    scores = dp[:, :, None] + logp_tr

    # ---- per-target best pred (class_rel.c:390-397)
    max_v, max_s = _emaxarg4(scores, 1)     # (B, t); ties -> E<R<H<D
    dead_t = max_v == NEG_INF
    sel = jnp.where(dead_t, 0, max_s)
    # exactness guard: flip distance of each per-target predecessor pick
    m_sel = _emin4(_top2_margin(scores, axis=1), 1)

    regs_i_n = _sel4(regs_i, sel)
    regs_b_n = _sel4(regs_b, sel)
    st_pos_n = regs_i_n[:, :, _SP:_SP + 4]
    st_cnt_n = regs_i_n[:, :, _SC:_SC + 4]
    lastH_n = regs_i_n[:, :, _LH:_LH + 2]
    lastD_n = regs_i_n[:, :, _LD:_LD + 2]
    lastHbD_n = regs_i_n[:, :, _LHBD:_LHBD + 2]
    lastDbH_n = regs_i_n[:, :, _LDBH:_LDBH + 2]
    exH_n = regs_b_n[:, :, _EXH]
    exD_n = regs_b_n[:, :, _EXD]
    exHbD_n = regs_b_n[:, :, _EXHBD]
    exDbH_n = regs_b_n[:, :, _EXDBH]
    hasH_n = regs_b_n[:, :, _HASH]
    hasD_n = regs_b_n[:, :, _HASD]

    off_end = epos_i[:, None] - OFF[:, None]                 # (B, 1)

    # REPEAT target st (class_rel.c:413-425)
    rp = st_pos_n[:, REPEAT, :]
    rc = st_cnt_n[:, REPEAT, :]
    r_cnt = jnp.minimum(ecnt_i, covR)
    keep_r = rc[:, REPEAT] < r_cnt
    newR_pos = rp.at[:, HAPLO].set(off_end[:, 0])
    newR_pos = newR_pos.at[:, DIPLO].set(off_end[:, 0])
    newR_pos = newR_pos.at[:, REPEAT].set(
        jnp.where(keep_r, rp[:, REPEAT], off_end[:, 0]))
    newR_cnt = rc.at[:, REPEAT].set(
        jnp.where(keep_r, rc[:, REPEAT], r_cnt))

    # dh ratio from registers (calc_dh_ratio, class_rel.c:113-156)
    def dh_ratio_of(init_s: int):
        if init_s == HAPLO:
            o2, oe2 = lastD_n[:, HAPLO, :], exD_n[:, HAPLO]
            o3, oe3 = lastHbD_n[:, HAPLO, :], exHbD_n[:, HAPLO]
        else:
            o2, oe2 = lastH_n[:, DIPLO, :], exH_n[:, DIPLO]
            o3, oe3 = lastDbH_n[:, DIPLO, :], exDbH_n[:, DIPLO]
        ok = oe2 & oe3
        s1p, s1c = bpos_i.astype(jnp.int64), bcnt_i
        tp, tc = o2[:, 0], o2[:, 1]
        s2p, s2c = o3[:, 0], o3[:, 1]
        # class_rel.c:134-138: the backward pass swaps s1 and s2
        s1p_, s1c_ = (jnp.where(fwd, s1p, s2p), jnp.where(fwd, s1c, s2c))
        s2p_, s2c_ = (jnp.where(fwd, s2p, s1p), jnp.where(fwd, s2c, s1c))
        est = (s2c_.astype(jnp.float64)
               + _div_cr(((s1c_ - s2c_) * (tp - s2p_)).astype(jnp.float64),
                         (s1p_ - s2p_).astype(jnp.float64)))
        tcf = tc.astype(jnp.float64)
        r = (_div_cr(est, tcf) if init_s == DIPLO
             else _div_cr(tcf, est))
        return jnp.where(ok, r, NEG_INF)

    rH = dh_ratio_of(HAPLO)
    rD = dh_ratio_of(DIPLO)

    # HAPLO target (class_rel.c:426-459)
    curr_h_H = ecnt_i
    curr_d_H = jnp.where(
        rH != NEG_INF, (rH * curr_h_H).astype(jnp.int64),
        jnp.where(hasD_n[:, HAPLO], st_cnt_n[:, HAPLO, DIPLO],
                  curr_h_H + covH))
    curr_r_H = (P.dr_ratio * curr_d_H).astype(jnp.int64)

    # DIPLO target (class_rel.c:460-493)
    curr_d_D = ecnt_i
    curr_h_D = jnp.where(
        rD != NEG_INF, (_div_cr(curr_d_D.astype(jnp.float64), rD)).astype(jnp.int64),
        jnp.where(hasH_n[:, DIPLO], st_cnt_n[:, DIPLO, HAPLO],
                  jnp.maximum(curr_d_D // 2, curr_d_D - covH)))
    curr_r_D = (P.dr_ratio * curr_d_D).astype(jnp.int64)

    # rebuild st rows with stacks instead of 14 scatter updates
    oe = off_end[:, 0]
    new_st_pos = jnp.stack([
        st_pos_n[:, ERROR, :], newR_pos,
        jnp.stack([st_pos_n[:, HAPLO, ERROR], oe, oe, oe], axis=1),
        jnp.stack([st_pos_n[:, DIPLO, ERROR], oe, oe, oe], axis=1)],
        axis=1)
    new_st_cnt = jnp.stack([
        st_cnt_n[:, ERROR, :], newR_cnt,
        jnp.stack([st_cnt_n[:, HAPLO, ERROR], curr_r_H, curr_h_H,
                   curr_d_H], axis=1),
        jnp.stack([st_cnt_n[:, DIPLO, ERROR], curr_r_D, curr_h_D,
                   curr_d_D], axis=1)], axis=1)

    ninf = jnp.full((B,), NEG_INF)
    new_dh = jnp.stack([ninf, ninf, rH, rD], axis=1)

    gate = ((new_st_cnt[:, :, HAPLO] < new_st_cnt[:, :, DIPLO])
            & (new_st_cnt[:, :, DIPLO] < new_st_cnt[:, :, REPEAT]))
    new_dp = jnp.where(dead_t | ~gate, NEG_INF, max_v)

    # path registers: extend with target t
    cur2 = jnp.broadcast_to(
        jnp.stack([epos_i, ecnt_i], axis=1)[:, None, :], (B, 4, 2))
    isH = iota4 == HAPLO
    isD = iota4 == DIPLO
    new_regs_i = jnp.concatenate([
        new_st_pos, new_st_cnt,
        jnp.where(isH[:, :, None], cur2, lastH_n),
        jnp.where(isD[:, :, None], cur2, lastD_n),
        jnp.where(isD[:, :, None], lastH_n, lastHbD_n),
        jnp.where(isH[:, :, None], lastD_n, lastDbH_n)], axis=2)
    new_regs_b = jnp.stack([
        exH_n | isH, exD_n | isD,
        jnp.where(isD, exH_n, exHbD_n),
        jnp.where(isH, exD_n, exDbH_n),
        hasH_n | isH, hasD_n | isD], axis=2)

    # ---- only_r overrides (class_rel.c:357-380): same-state copy
    alive = dp != NEG_INF
    eff2 = jnp.broadcast_to(eff[:, None, :], (B, 4, 2))
    oH = isH & alive
    oD = isD & alive
    o_regs_i = jnp.concatenate([
        regs_i[:, :, _SP:_SC + 4],
        jnp.where(oH[:, :, None], eff2, regs_i[:, :, _LH:_LH + 2]),
        jnp.where(oD[:, :, None], eff2, regs_i[:, :, _LD:_LD + 2]),
        jnp.where(oD[:, :, None], regs_i[:, :, _LH:_LH + 2],
                  regs_i[:, :, _LHBD:_LHBD + 2]),
        jnp.where(oH[:, :, None], regs_i[:, :, _LD:_LD + 2],
                  regs_i[:, :, _LDBH:_LDBH + 2])], axis=2)
    o_regs_b = jnp.stack([
        regs_b[:, :, _EXH] | oH, regs_b[:, :, _EXD] | oD,
        jnp.where(oD, regs_b[:, :, _EXH], regs_b[:, :, _EXHBD]),
        jnp.where(oH, regs_b[:, :, _EXD], regs_b[:, :, _EXDBH]),
        regs_b[:, :, _HASH] | oH, regs_b[:, :, _HASD] | oD], axis=2)

    live = i < m

    def pick(upd, onr, old):
        shape = (B,) + (1,) * (upd.ndim - 1)
        return jnp.where(live.reshape(shape),
                         jnp.where(only_r.reshape(shape), onr, upd), old)

    # exactness guard: the only_r decision margin always counts; the
    # selection/coupling/truncation margins only matter when the step
    # actually selects (not only_r).  has_inf rows are always flagged:
    # their NaN poisoning makes argmax semantics backend-dependent
    # (the elementwise first-wins trees above skip NaN where jnp.argmax
    # would treat it as maximal), so the host decides them exactly.
    m_poison = jnp.where(has_inf, 1e-30, jnp.inf)
    step_margin = jnp.minimum(
        jnp.minimum(m_onlyr, jnp.minimum(m_band, m_poison)),
        jnp.where(only_r, jnp.inf, jnp.minimum(m_coup, m_sel)))
    mmin_n = jnp.where(live, jnp.minimum(mmin, step_margin), mmin)

    carry_n = (
        pick(new_dp, dp, dp),
        pick(new_dh, jnp.full((B, 4), NEG_INF), dh),
        pick(new_regs_i, o_regs_i, regs_i),
        pick(new_regs_b, o_regs_b, regs_b),
        pick(jnp.stack([epos_i, ecnt_i], axis=1), eff, eff),
        mmin_n,
    )
    bp = jnp.where(live[:, None],
                   jnp.where(only_r[:, None], iota4,
                             jnp.where(dead_t, N_STATE, max_s)),
                   N_STATE).astype(jnp.int8)
    return carry_n, (bp, live & only_r)


@functools.partial(jax.jit, static_argnames=("max_m", "lanes"))
def rel_dp_pass2(bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE_all,
                 m, plen, fwd, cov, P: RelParams2, max_m: int,
                 lanes: int = 1):
    """One merged-direction DP pass over (B, max_m) interval arrays.

    All arrays are in *scan order* (backward rows index-reversed by the
    caller) with boundary roles resolved per direction: ``bpos/bcnt``
    enter each interval, ``epos/ecnt`` leave it.  ``max_cc`` =
    max(ccb, cce); ``lf_bcnt`` = logfact[bcnt]; ``logpE_all`` = the full
    E emission — data-only, shared between the main and rescue passes.

    ``lanes`` splits the rows into independent carry chains whose
    latencies overlap inside the single scan (B must divide by lanes).

    Returns (asgn int8 (B,max_m) in scan order, final dp (B,4),
    min decision margin (B,) — the exactness-guard vector: the smallest
    flip distance over every argmax/truncation this row's scan made;
    rows below the engine's epsilon are host-recomputed exactly).
    """
    B = bpos.shape[0]
    fwd = fwd.astype(bool)
    assert B % lanes == 0
    Lb = B // lanes

    def lane_inputs(s):
        sl = slice(s * Lb, (s + 1) * Lb)
        fw = fwd[sl]
        covL = cov[sl]
        return {
            "bpos": bpos[sl], "bcnt": bcnt[sl], "epos": epos[sl],
            "ecnt": ecnt[sl], "max_cc": max_cc[sl],
            "lf_bcnt": lf_bcnt[sl], "logpE": logpE_all[sl],
            "m": m[sl], "plen": plen[sl], "fwd": fw, "cov": covL,
            "OFF": jnp.where(fw, P.offset, -P.offset).astype(jnp.int64),
            "PSTEP": jnp.where(fw, 1, -1).astype(jnp.int64),
            "covR": covL[:, REPEAT].astype(jnp.int64),
            "covH": covL[:, HAPLO].astype(jnp.int64),
        }

    Ls = [lane_inputs(s) for s in range(lanes)]
    carry0 = tuple(_lane_init(L, P) for L in Ls)
    steps = jnp.arange(1, max_m)
    xs = tuple((L["bpos"][:, 1:].T, L["bcnt"][:, 1:].T,
                L["epos"][:, 1:].T, L["ecnt"][:, 1:].T,
                L["max_cc"][:, 1:].T, L["lf_bcnt"][:, 1:].T,
                L["logpE"][:, 1:].T, steps) for L in Ls)
    consts = [{k: L[k] for k in ("cov", "fwd", "OFF", "PSTEP", "covR",
                                 "covH", "m")} for L in Ls]

    # dynamic-trip while loop: rows beyond a row's own m are no-ops via
    # the in-step `live` mask, so running only max(m)-1 iterations (vs
    # the padded max_m-1) is exactly equivalent; the output buffers'
    # initial values equal the dead steps' outputs (bp = N_STATE,
    # only_r = False)
    trip = jnp.maximum(jnp.max(m) - 1, 0).astype(jnp.int32)
    bp_buf0 = tuple(jnp.full((max_m - 1, Lb, 4), N_STATE, jnp.int8)
                    for _ in range(lanes))
    rp_buf0 = tuple(jnp.zeros((max_m - 1, Lb), bool) for _ in range(lanes))

    def w_cond(st):
        return st[0] < trip

    def w_body(st):
        t, carries, bp_bufs, rp_bufs = st
        new = []
        bp_n = []
        rp_n = []
        for s in range(lanes):
            xs_t = jax.tree_util.tree_map(
                lambda a: jax.lax.dynamic_index_in_dim(
                    a, t, 0, keepdims=False), xs[s])
            c_n, (bp, rp) = _lane_step(carries[s], xs_t, consts[s], P)
            new.append(c_n)
            bp_n.append(jax.lax.dynamic_update_index_in_dim(
                bp_bufs[s], bp, t, 0))
            rp_n.append(jax.lax.dynamic_update_index_in_dim(
                rp_bufs[s], rp, t, 0))
        return t + 1, tuple(new), tuple(bp_n), tuple(rp_n)

    if "nodp" in _ABLATE:   # MEASUREMENT-ONLY (CP_ABLATE)
        carry_f, bp_bufs, rp_bufs = carry0, bp_buf0, rp_buf0
    else:
        _, carry_f, bp_bufs, rp_bufs = jax.lax.while_loop(
            w_cond, w_body, (jnp.int32(0), carry0, bp_buf0, rp_buf0))
    outs = tuple((bp_bufs[s], rp_bufs[s]) for s in range(lanes))

    # ---------------- traceback (class_rel.c:606-613) --------------------
    asgns = []
    dps = []
    mms = []
    for s in range(lanes):
        bps, rposs = outs[s]
        dp_f = carry_f[s][0]
        dps.append(dp_f)
        # row margin = min(step margins, final state argmax margin).
        # An ALL-DEAD final cell (every dp -inf — reachable via the
        # psum==0 fallback, class_rel.c:326-331, fixture branch/psum0)
        # is force-flagged: _top2_margin's isneginf clause returns +inf
        # there, but the C traceback reads an uninitialized bt row for
        # such reads, so they must always go to the host exact oracle
        # (which pins the fresh-workspace all-ERROR semantics).
        fin_m = _top2_margin(dp_f, axis=1)
        # min FIRST, then the all-dead override: an earlier exact-tie
        # step margin of exactly 0.0 (exempt by design) must not mask
        # the force-flag via min(0.0, 1e-30) == 0.0 (ADVICE r4).
        mm = jnp.minimum(carry_f[s][5], fin_m)
        if not _NO_GUARD:
            all_dead = _eall4(dp_f == NEG_INF, 1)
            mm = jnp.where(all_dead, 1e-30, mm)
        mms.append(mm)
        bps = jnp.moveaxis(bps, 0, 1)       # (Lb, max_m-1, 4)
        rpos = jnp.concatenate(
            [jnp.zeros((Lb, 1), bool), jnp.moveaxis(rposs, 0, 1)], axis=1)
        last = jnp.maximum(Ls[s]["m"] - 1, 0)
        cur0 = _emaxarg4(dp_f, 1)[1]

        # dynamic-trip walk j = max(last)..1 (columns past the batch
        # maximum keep cur0, exactly as the padded steps did)
        trip = jnp.maximum(jnp.max(last), 0).astype(jnp.int32)
        buf0 = jnp.broadcast_to(cur0[:, None], (Lb, max_m)).astype(jnp.int32)

        def tb_cond(st):
            return st[0] < trip

        def tb_step(st, last=last, bps=bps):
            t, cur, buf = st
            j = trip - t
            buf = jax.lax.dynamic_update_slice(
                buf, cur[:, None], (jnp.int32(0), j))
            bp_j = jax.lax.dynamic_index_in_dim(bps, j - 1, 1,
                                                keepdims=False)
            cc = jnp.clip(cur, 0, 3)
            prev = jnp.where(
                cc == 0, bp_j[:, 0],
                jnp.where(cc == 1, bp_j[:, 1],
                          jnp.where(cc == 2, bp_j[:, 2],
                                    bp_j[:, 3]))).astype(jnp.int32)
            cur = jnp.where(j <= last, prev, cur)
            return t + 1, cur, buf

        if "notb" in _ABLATE:   # MEASUREMENT-ONLY (CP_ABLATE)
            state0, buf = cur0, buf0
        else:
            _, state0, buf = jax.lax.while_loop(
                tb_cond, tb_step, (jnp.int32(0), cur0, buf0))
        asgn = jnp.concatenate(
            [state0[:, None], buf[:, 1:]], axis=1).astype(jnp.int8)
        asgn = jnp.where(rpos, jnp.int8(REPEAT), asgn)
        asgns.append(asgn)
    return (jnp.concatenate(asgns, axis=0), jnp.concatenate(dps, axis=0),
            jnp.concatenate(mms, axis=0))
