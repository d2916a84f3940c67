"""Batched unreliable-interval relaxation on device, v2 (ref class_unrel.c).

Redesign of unrel_dev.py that minimises gathers inside loops (see
rel_dev2.py): the two relaxation sweeps remain genuinely sequential
`lax.scan`s (later steps read earlier updates), but each step now costs
two small gathers instead of ~30:

* per-interval static terms (boundary counts/positions, Poisson
  emissions, log-factorials, wall error log-probs) are precomputed ONCE
  per call outside the scan (device_pipeline.py derives them from the
  compact int planes) and packed into a (B, N, 13) value tensor; each
  step reads its interval's row with a single one-hot contraction;
* dynamic values (the evolving assignment vector, nearest-reliable-
  neighbor searches and the values at those neighbors) are masked
  reductions / one-hot contractions over the (B, N) interval axis — no
  gathers;
* the four Skellam drift terms of a step run as ONE packed-table call;
  the four binomial-tail lookups as ONE flat gather.

Semantics identical to unrel_dev.py (argmax decisions, C special
cases); byte-identity re-verified end to end by tests.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from classpro_tpu.tpu.rel_dev2 import _div_cr, _top2_margin
from classpro_tpu.tpu.skellam_dev import PackedSkellam, logp_skellam_packed

ERROR, REPEAT, HAPLO, DIPLO, N_STATE = 0, 1, 2, 3, 4
NEG_INF = float("-inf")
BIG = np.int32(1 << 30)      # host scalar: importing touches no device

# plane order in the per-interval static value tensor `P13`
(_CB, _CE, _LFCB, _LFCE, _XL, _XR, _LE,
 _POHB, _POHE, _PODB, _PODE, _PEOB, _PEOE) = range(13)


class UnrelParams2(NamedTuple):
    ps: PackedSkellam
    lf_small: jnp.ndarray    # (n1,) logfact head (one-hot R-binomial)
    btg_flat: jnp.ndarray    # (n_cap*n_cap,) log binom tail at erate 0.1
    n_cap: int
    read_len: float
    r_logp: float
    log_1m_pe_mean: float
    log_pe_mean: float
    dr_ratio: float
    cov_r: int
    cov_h: int
    cov_d: int


def _lf_oh(idx, lf_small):
    n1 = lf_small.shape[0]
    i = jnp.clip(idx, 0, n1 - 1)
    oh = jnp.arange(n1) == i[..., None]
    return jnp.sum(jnp.where(oh, lf_small, 0.0), axis=-1)


@functools.partial(jax.jit, static_argnames=("max_n", "lanes"))
def unrel_sweeps2(dyn, xs_desc, xs_asc, n, P: UnrelParams2, max_n: int,
                  lanes: int = 1):
    """Two relaxation sweeps (class_unrel.c:248-300).

    dyn: dict of device arrays in ORIGINAL interval order —
      is_rel (bool (B,N)), asgn (int32 (B,N), N_STATE = unclassified),
      P13 (f64 (B,N,13), plane order per module constants),
      packL = stack(cce, e-1, ce) and packR = stack(ccb, b, cb)
      (f64 (B,N,3)) — corrected counts/positions for drift/coverage
      estimation plus uncorrected ce/cb for the repeat test's neighbor
      coverages (class_unrel.c:73-81).
    xs_desc / xs_asc: dicts of (B, N) per-step inputs in processing
      order — idx (int32 interval index, 0 where not live), live (bool).
    n: (B,) int32 interval counts.

    ``lanes`` splits rows into independent carry chains whose gather and
    op latencies overlap inside the single scan (see rel_dev2.py).

    Returns (final asgn (B, N) int8, min decision margin (B,) — the
    exactness-guard vector, rel_dev2.py semantics).
    """
    B = n.shape[0]
    assert B % lanes == 0
    Lb = B // lanes
    if lanes > 1:
        parts = []
        for s in range(lanes):
            sl = slice(s * Lb, (s + 1) * Lb)
            parts.append(_unrel_lane(
                {k: v[sl] for k, v in dyn.items()},
                {k: v[sl] for k, v in xs_desc.items()},
                {k: v[sl] for k, v in xs_asc.items()},
                n[sl], P, max_n))
        carries, runners = zip(*parts)

        def sweep(asgns, which):
            def body(a_t, x_t):
                out, ms = [], []
                for s in range(lanes):
                    a2, m = runners[s](a_t[s], x_t[s])
                    out.append(a2)
                    ms.append(m)
                return tuple(out), tuple(ms)
            xs_t = tuple(c.xs[which] for c in carries)
            a, ms = jax.lax.scan(body, tuple(asgns), xs_t)
            return a, tuple(jnp.min(m, axis=0) for m in ms)

        asgns = tuple(c.asgn0 for c in carries)
        asgns, mm1 = sweep(asgns, 0)
        asgns, mm2 = sweep(asgns, 1)
        mm = jnp.concatenate([jnp.minimum(a, b)
                              for a, b in zip(mm1, mm2)], axis=0)
        return (jnp.concatenate([a.astype(jnp.int8) for a in asgns],
                                axis=0), mm)

    carry, runner = _unrel_lane(dyn, xs_desc, xs_asc, n, P, max_n)

    a, ms1 = jax.lax.scan(runner, carry.asgn0, carry.xs[0])
    a, ms2 = jax.lax.scan(runner, a, carry.xs[1])
    mm = jnp.minimum(jnp.min(ms1, axis=0), jnp.min(ms2, axis=0))
    return a.astype(jnp.int8), mm


class _LaneState(NamedTuple):
    asgn0: jnp.ndarray
    xs: tuple


def _unrel_lane(dyn, xs_desc, xs_asc, n, P: UnrelParams2, max_n: int):
    """Build one lane's initial state and step runner.

    The step body is latency-bound on op COUNT inside the device loop
    (each small op has a fixed cost regardless of size), so all per-state /
    per-side work is stacked into lane axes: the four nearest-neighbor
    searches run as one (B,2,N) masked reduction pair, the four
    neighbor-value reads as one (B,4,N,3) one-hot contraction, the four
    coverage interpolations / Skellam drifts / tail lookups as (B,4)
    vectors, and the two per-state side combinations as (B,2)."""
    cols = jnp.arange(max_n, dtype=jnp.int32)[None, :]
    valid = cols < n[:, None]
    is_rel = dyn["is_rel"] & valid
    asgn0 = dyn["asgn"].astype(jnp.int32)
    is_fixed = is_rel & ((asgn0 == HAPLO) | (asgn0 == DIPLO))

    packL, packR = dyn["packL"], dyn["packR"]
    # neighbor-value planes for slots [H-left, H-right, D-left, D-right]
    packLR4 = jnp.stack([packL, packR, packL, packR], axis=1)
    P13 = dyn["P13"]
    S2 = jnp.asarray([HAPLO, DIPLO], jnp.int32)[None, :, None]   # (1,2,1)

    def step_fn(asgn, x):
        idx = x["idx"]
        # fused one-hot for (idx-1, idx, idx+1): assignments of the
        # interval and its original-order neighbors in one reduction
        idx3 = jnp.stack([idx - 1, idx, idx + 1], axis=1)       # (B,3)
        oh3 = cols[:, None, :] == idx3[:, :, None]              # (B,3,N)
        a3 = jnp.sum(jnp.where(oh3, asgn[:, None, :], 0), axis=2)
        nb, cur, na = a3[:, 0], a3[:, 1], a3[:, 2]
        oh_idx = oh3[:, 1, :]
        v = jnp.sum(jnp.where(oh_idx[:, :, None], P13, 0.0), axis=1)
        icb = v[:, _CB].astype(jnp.int64)
        ice = v[:, _CE].astype(jnp.int64)
        x_l, x_r = v[:, _XL], v[:, _XR]
        lE = v[:, _LE]

        # ---- nearest reliable H/D neighbors, one fused search --------
        # (class_unrel.c:11-25)
        match = is_rel[:, None, :] & (asgn[:, None, :] == S2)   # (B,2,N)
        in_l = match & (cols < idx[:, None])[:, None, :]
        lHD = jnp.max(jnp.where(in_l, cols[:, None, :], -1), axis=2)
        in_r = match & (cols > idx[:, None])[:, None, :]
        rHD = jnp.min(jnp.where(in_r, cols[:, None, :], BIG), axis=2)
        rHD = jnp.where(rHD == BIG, -1, rHD)
        # slot order [H-left, H-right, D-left, D-right]
        J4 = jnp.stack([lHD[:, 0], rHD[:, 0], lHD[:, 1], rHD[:, 1]], axis=1)
        ohJ = cols[:, None, :] == J4[:, :, None]                # (B,4,N)
        V4 = jnp.sum(jnp.where(ohJ[:, :, :, None], packLR4, 0.0), axis=2)
        nn_ok = J4 != -1                                        # (B,4)
        # V4[:, j] = (cce, e-1, ce) at left slots / (ccb, b, cb) at right

        # ---- logp_r_u (class_unrel.c:67-113): uncorrected nbr counts
        cov_d_f = jnp.asarray(P.cov_d, jnp.float64)
        dl = jnp.where(nn_ok[:, 2], V4[:, 2, 2],
                       jnp.where(nn_ok[:, 3], V4[:, 3, 2], cov_d_f))
        dr = jnp.where(nn_ok[:, 3], V4[:, 3, 2],
                       jnp.where(nn_ok[:, 2], V4[:, 2, 2], cov_d_f))
        rlrr = (P.dr_ratio * jnp.stack([dl, dr], axis=1)).astype(jnp.int64)
        k2 = jnp.stack([icb, ice], axis=1)                      # (B,2)
        over = jnp.any(k2 >= rlrr, axis=1)
        lf2 = jnp.stack([v[:, _LFCB], v[:, _LFCE]], axis=1)
        bi2 = (_lf_oh(rlrr, P.lf_small) - lf2
               - _lf_oh(rlrr - k2, P.lf_small)
               + k2 * P.log_1m_pe_mean + (rlrr - k2) * P.log_pe_mean)
        lp_r = bi2[:, 0] + bi2[:, 1]
        hi = jnp.maximum(icb, ice) >= P.cov_r
        lR = jnp.where(hi, 0.0, jnp.where(over, P.r_logp, lp_r))

        # ---- est_cov for (H,D) x (left,right) lanes (class_unrel.c:27-43)
        xq4 = jnp.stack([x_l, x_r, x_l, x_r], axis=1)           # (B,4)
        lj = jnp.stack([lHD[:, 0], lHD[:, 0], lHD[:, 1], lHD[:, 1]], axis=1)
        rj = jnp.stack([rHD[:, 0], rHD[:, 0], rHD[:, 1], rHD[:, 1]], axis=1)
        Lc = jnp.stack([V4[:, 0, 0], V4[:, 0, 0],
                        V4[:, 2, 0], V4[:, 2, 0]], axis=1)
        Le = jnp.stack([V4[:, 0, 1], V4[:, 0, 1],
                        V4[:, 2, 1], V4[:, 2, 1]], axis=1)
        Rc = jnp.stack([V4[:, 1, 0], V4[:, 1, 0],
                        V4[:, 3, 0], V4[:, 3, 0]], axis=1)
        Rb = jnp.stack([V4[:, 1, 1], V4[:, 1, 1],
                        V4[:, 3, 1], V4[:, 3, 1]], axis=1)
        l_ok, r_ok = lj != -1, rj != -1
        both = l_ok & r_ok
        interp = Lc + _div_cr((Rc - Lc) * (xq4 - Le), Rb - Le)
        val4 = jnp.where(both, interp.astype(jnp.int64),
                         jnp.where(l_ok, Lc.astype(jnp.int64),
                                   jnp.where(r_ok, Rc.astype(jnp.int64), 0)))
        found4 = l_ok | r_ok
        # cross-state fallback: other state's value at the same side
        val_o = jnp.concatenate([val4[:, 2:], val4[:, :2]], axis=1)
        found_o = jnp.concatenate([found4[:, 2:], found4[:, :2]], axis=1)
        fb = jnp.where(
            found_o & (val_o > 0),
            jnp.where(jnp.arange(4)[None, :] < 2, val_o // 2, val_o * 2),
            jnp.where(jnp.arange(4)[None, :] < 2, P.cov_h, P.cov_d))
        estf = jnp.where(found4, val4, fb)

        # ---- Skellam drift to the neighbors (one packed call) --------
        cnt4 = jnp.stack([icb, ice, icb, ice], axis=1)
        sign4 = jnp.asarray([1, -1, 1, -1])[None, :]
        kk = sign4 * (cnt4 - V4[:, :, 0].astype(jnp.int64))
        lamm = V4[:, :, 0] * jnp.abs(xq4 - V4[:, :, 1]) / P.read_len
        sk = logp_skellam_packed(kk, lamm, P.ps)

        # ---- binomial tails at the estimated coverages ---------------
        nq = jnp.clip(estf, 1, P.n_cap - 1)
        kq = jnp.clip(estf - cnt4, 0, P.n_cap - 1)
        tails = P.btg_flat[(nq * P.n_cap + kq).astype(jnp.int32)]
        sfe = jnp.where(estf >= cnt4, tails, NEG_INF)

        # ---- per-state side combination (class_unrel.c:115-183) ------
        S2f = S2[:, :, 0]                                       # (1,2)
        er_l = jnp.where(((idx - 1 >= 0)[:, None]) & (nb[:, None] == S2f),
                         v[:, _PEOB][:, None], NEG_INF)
        er_r = jnp.where((((idx + 1) < n)[:, None]) & (na[:, None] == S2f),
                         v[:, _PEOE][:, None], NEG_INF)
        sf_l = jnp.where(nn_ok[:, 0::2], sk[:, 0::2], NEG_INF)
        sf_r = jnp.where(nn_ok[:, 1::2], sk[:, 1::2], NEG_INF)
        logp_l = jnp.maximum(jnp.maximum(er_l, sf_l), sfe[:, 0::2])
        logp_r_ = jnp.maximum(jnp.maximum(er_r, sf_r), sfe[:, 1::2])
        po_b = jnp.stack([v[:, _POHB], v[:, _PODB]], axis=1)
        po_e = jnp.stack([v[:, _POHE], v[:, _PODE]], axis=1)
        both_inf = (logp_l == NEG_INF) & (logp_r_ == NEG_INF)
        lp_l = jnp.where(both_inf, po_b,
                         jnp.where(logp_l == NEG_INF, logp_r_, logp_l))
        lp_r = jnp.where(both_inf, po_e,
                         jnp.where(logp_r_ == NEG_INF, lp_l, logp_r_))
        lHD_ = lp_l + lp_r                                      # (B,2)

        cand = jnp.concatenate([lE[:, None], lR[:, None], lHD_], axis=1)
        smax = jnp.argmax(cand, axis=1)
        force_r = jnp.maximum(icb, ice) >= P.cov_r
        new = jnp.where(force_r, REPEAT, smax).astype(jnp.int32)

        fixed_at = jnp.any(oh_idx & is_fixed, axis=1)
        active = x["live"] & ~fixed_at
        upd = jnp.where(active, new, cur)
        asgn = jnp.where(oh_idx & active[:, None], upd[:, None],
                         asgn).astype(jnp.int32)
        # exactness-guard margin (same contract as rel_dev2): the
        # Skellam drift terms carry ~1e-9 table error; a forced-REPEAT
        # decision is an exact int compare (margin irrelevant)
        m_step = _top2_margin(cand, axis=1)
        m_step = jnp.where(force_r | ~active, jnp.inf, m_step)
        return asgn, m_step

    # scan xs: transpose (B, N) -> (N, B) per processing order
    xs = tuple({k: v.T for k, v in o.items()} for o in (xs_desc, xs_asc))
    return _LaneState(asgn0=asgn0, xs=xs), step_fn
