"""Device-side modified Bessel I_n and Skellam log-pmf (float64).

Replicates the reference's Numerical-Recipes implementation
(bessel.c:390-520) so device values agree with the C binary to the last
few ulps — the reference's own polynomials are only ~1e-7 accurate vs the
true Bessel function, so using a *better* approximation would hurt
concordance.

The downward recurrence of bessi(n, x) has a data-dependent start index
2*(n + floor(sqrt(40 n))); on device we run a fixed-length masked loop
from a static NMAX bound, which executes identical arithmetic for the
active range (verified bit-exact vs the scalar implementation on CPU).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_BIGNO = 1.0e10
_BIGNI = 1.0e-10

#: max |k| supported by the fixed-length recurrence (counts are < 2^15 but
#: Skellam arguments in the pipeline are bounded by count deltas < ~512)
NMAX_DEFAULT = 520


def bessi0(x):
    ax = jnp.abs(x)
    y_small = (x / 3.75) ** 2
    small = 1.0 + y_small * (3.5156229 + y_small * (3.0899424 + y_small * (1.2067492
            + y_small * (0.2659732 + y_small * (0.360768e-1 + y_small * 0.45813e-2)))))
    y_big = 3.75 / jnp.maximum(ax, 1e-300)
    big = (jnp.exp(ax) / jnp.sqrt(jnp.maximum(ax, 1e-300))) * (0.39894228
          + y_big * (0.1328592e-1 + y_big * (0.225319e-2 + y_big * (-0.157565e-2
          + y_big * (0.916281e-2 + y_big * (-0.2057706e-1 + y_big * (0.2635537e-1
          + y_big * (-0.1647633e-1 + y_big * 0.392377e-2))))))))
    return jnp.where(ax < 3.75, small, big)


def bessi1(x):
    ax = jnp.abs(x)
    y_small = (x / 3.75) ** 2
    small = ax * (0.5 + y_small * (0.87890594 + y_small * (0.51498869
            + y_small * (0.15084934 + y_small * (0.2658733e-1
            + y_small * (0.301532e-2 + y_small * 0.32411e-3))))))
    y_big = 3.75 / jnp.maximum(ax, 1e-300)
    inner = 0.2282967e-1 + y_big * (-0.2895312e-1 + y_big * (0.1787654e-1
            - y_big * 0.420059e-2))
    big = (0.39894228 + y_big * (-0.3988024e-1 + y_big * (-0.362018e-2
          + y_big * (0.163801e-2 + y_big * (-0.1031555e-1 + y_big * inner)))))
    big = big * (jnp.exp(ax) / jnp.sqrt(jnp.maximum(ax, 1e-300)))
    ans = jnp.where(ax < 3.75, small, big)
    return jnp.where(x < 0.0, -ans, ans)


def bessi(n, x, nmax: int = NMAX_DEFAULT):
    """I_n(x) elementwise for integer-array n >= 0 (bessel.c:478-520).

    Fixed-length masked downward recurrence: iterations above the
    element's true start index leave its state untouched, so the active
    arithmetic matches the scalar loop exactly.
    """
    n = jnp.asarray(n, jnp.int32)
    x = jnp.asarray(x, jnp.float64)
    jstart = 2 * (n + jnp.floor(jnp.sqrt(40.0 * n)).astype(jnp.int32))
    jmax = 2 * (nmax + int((40.0 * nmax) ** 0.5))

    tox = 2.0 / jnp.maximum(jnp.abs(x), 1e-300)

    def body(jj, state):
        bi, bip, ans = state
        j = jmax - jj  # descending j = jmax .. 1
        active = j <= jstart
        bim = bip + j * tox * bi
        bip_n = jnp.where(active, bi, bip)
        bi_n = jnp.where(active, bim, bi)
        over = jnp.abs(bi_n) > _BIGNO
        scale = jnp.where(active & over, _BIGNI, 1.0)
        ans_n = jnp.where(active, ans, ans) * scale
        bi_n = bi_n * scale
        bip_n = bip_n * scale
        ans_n = jnp.where(active & (j == n), bip_n, ans_n)
        return bi_n, bip_n, ans_n

    bi0 = jnp.ones_like(x)
    bip0 = jnp.zeros_like(x)
    ans0 = jnp.zeros_like(x)
    bi, bip, ans = jax.lax.fori_loop(0, jmax, body, (bi0, bip0, ans0))
    res = ans * (bessi0(x) / bi)  # C: ans *= bessi0(x)/bi — association matters
    res = jnp.where(x == 0.0, 0.0, res)
    res = jnp.where(n == 0, bessi0(x), jnp.where(n == 1, bessi1(x), res))
    return res


def logp_skellam(k, lam, nmax: int = NMAX_DEFAULT):
    """prob.c:41 — -2*lam + log(I_|k|(2*lam)), elementwise."""
    k = jnp.abs(jnp.asarray(k, jnp.int32))
    lam = jnp.asarray(lam, jnp.float64)
    return -2.0 * lam + jnp.log(bessi(k, 2.0 * lam, nmax=nmax))


def logp_poisson(k, lam, logfact):
    """prob.c:33 — k*log(lam) - lam - logfact[k] (k clamped to table)."""
    k = jnp.minimum(jnp.asarray(k, jnp.int32), logfact.shape[0] - 1)
    lam = jnp.asarray(lam, jnp.float64)
    return k * jnp.log(lam) - lam - logfact[k]
