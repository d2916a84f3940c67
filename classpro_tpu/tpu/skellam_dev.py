"""Device log-Skellam via host-built interpolation tables.

The DP evaluates logp_skellam(k, lam) = -2*lam + log I_|k|(2*lam) at
arbitrary real lam (util.c:35), so no exact tabulation exists.  We build
two smooth tables of log I_n(x) from the *C-replica* Bessel (so table
nodes carry the reference's own ~1e-7 approximation error, maximizing
agreement with the C binary) and interpolate with 4-point cubics:

* region A, x in [0, 64], uniform grid:   h(n,x) = log I_n(x) - n*log(x/2)
                                          + logfact[n]   (smooth, h(n,0)=0)
* region B, x in (64, X_MAX], uniform in sqrt(x):  g(n,x) = log I_n(x) - x

Host build uses one vectorized Miller downward recurrence per grid x,
yielding all orders n <= NMAX at once (identical arithmetic to
bessel.c:478-520, vectorized across grid points).

Accuracy: interpolation error ~1e-9 in log-space; C's own Bessel error is
~1e-7, so device values sit within the reference's noise floor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

from classpro_tpu.numerics import LOGFACT, bessi0 as _bessi0_scalar

NMAX = 384
XA_MAX = 64.0
NA_GRID = 2048
XB_MAX = 16384.0
NB_GRID = 4096

_BIGNO = 1.0e10
_BIGNI = 1.0e-10


def _bessi_grid(xs: np.ndarray, nmax: int) -> np.ndarray:
    """I_n(x) for all n in [0, nmax] x grid xs, shape (nmax+1, len(xs)).

    Runs the per-order downward recurrence (bessel.c:478-520) for every
    (n, x) pair simultaneously: each matrix column/row keeps independent
    state, activated at its own start index jstart(n) — identical
    arithmetic to the scalar C loop."""
    from classpro_tpu.numerics import bessi1 as _b1

    xs = np.asarray(xs, np.float64)
    G = xs.size
    ns = np.arange(2, nmax + 1)
    jstart = (2 * (ns + np.floor(np.sqrt(40.0 * ns)))).astype(np.int64)[:, None]
    jmax = int(jstart.max())
    tox = 2.0 / np.maximum(np.abs(xs), 1e-300)[None, :]
    bi = np.ones((ns.size, G))
    bip = np.zeros((ns.size, G))
    ans = np.zeros((ns.size, G))
    nsc = ns[:, None]
    for j in range(jmax, 0, -1):
        active = j <= jstart
        bim = bip + (j * tox) * bi
        np.copyto(bip, bi, where=active)
        np.copyto(bi, bim, where=active)
        over = active & (np.abs(bi) > _BIGNO)
        scale = np.where(over, _BIGNI, 1.0)
        ans *= scale
        bi *= scale
        bip *= scale
        np.copyto(ans, bip, where=active & (j == nsc))
    i0 = np.array([_bessi0_scalar(float(x)) for x in xs])
    out = np.empty((nmax + 1, G))
    out[0] = i0
    out[1] = np.array([_b1(float(x)) for x in xs])
    out[2:] = ans * (i0[None, :] / bi)
    out[2:, xs == 0.0] = 0.0
    return out


@dataclasses.dataclass
class SkellamTables:
    table_a: np.ndarray  # (NMAX+1, NA_GRID) h(n, x)
    table_b: np.ndarray  # (NMAX+1, NB_GRID) g(n, x), grid uniform in sqrt(x)
    logfact: np.ndarray


_CACHE: dict[int, SkellamTables] = {}


def _cache_path(nmax: int) -> str:
    import os

    d = os.environ.get("CLASSPRO_CACHE",
                       os.path.join(os.path.expanduser("~"), ".cache",
                                    "classpro_tpu"))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"skellam_n{nmax}_a{NA_GRID}_b{NB_GRID}.npz")


def build_skellam_tables(nmax: int = NMAX) -> SkellamTables:
    if nmax in _CACHE:
        return _CACHE[nmax]
    import os

    path = _cache_path(nmax)
    if os.path.exists(path):
        z = np.load(path)
        t = SkellamTables(z["ta"], z["tb"], LOGFACT.copy())
        _CACHE[nmax] = t
        return t

    ns = np.arange(nmax + 1)[:, None]
    lf = LOGFACT[: nmax + 1][:, None]

    xa = np.linspace(0.0, XA_MAX, NA_GRID)
    iva = _bessi_grid(xa, nmax)
    with np.errstate(divide="ignore", invalid="ignore"):
        ha = np.log(iva) - ns * np.log(np.maximum(xa, 1e-300)[None, :] / 2.0) + lf
    # underflowed I (or x=0) -> series first term is exact: h -> 0
    ta = np.where(np.isfinite(ha), ha, 0.0)
    ta[:, xa == 0.0] = 0.0

    ub = np.linspace(math.sqrt(XA_MAX), math.sqrt(XB_MAX), NB_GRID)
    xb = ub * ub
    ivb = _bessi_grid(xb, nmax)
    with np.errstate(divide="ignore", invalid="ignore"):
        gb = np.log(ivb) - xb[None, :]
    # the C replica overflows to inf for huge x (as the reference itself
    # would); fill those nodes with scipy's scaled Bessel so interpolation
    # stays smooth — the reference's value there is +inf either way.
    bad = ~np.isfinite(gb)
    if bad.any():
        import scipy.special as sp

        full = np.log(sp.ive(np.arange(nmax + 1)[:, None], xb[None, :]))
        gb = np.where(bad, full, gb)
    tb = gb

    t = SkellamTables(ta, tb, LOGFACT.copy())
    np.savez_compressed(path, ta=ta, tb=tb)
    _CACHE[nmax] = t
    return t


def _cubic_gather(table: jnp.ndarray, n: jnp.ndarray, pos: jnp.ndarray,
                  npts: int) -> jnp.ndarray:
    """4-point Lagrange interpolation along axis 1 at real ``pos`` for
    integer row ``n``."""
    i1 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 1, npts - 3)
    f = pos - i1
    y0 = table[n, i1 - 1]
    y1 = table[n, i1]
    y2 = table[n, i1 + 1]
    y3 = table[n, i1 + 2]
    # Lagrange weights for nodes -1, 0, 1, 2 at offset f
    w0 = -f * (f - 1.0) * (f - 2.0) / 6.0
    w1 = (f + 1.0) * (f - 1.0) * (f - 2.0) / 2.0
    w2 = -(f + 1.0) * f * (f - 2.0) / 2.0
    w3 = (f + 1.0) * f * (f - 1.0) / 6.0
    return w0 * y0 + w1 * y1 + w2 * y2 + w3 * y3


def log_bessi_dev(n, x, ta, tb, logfact):
    """log I_n(x) elementwise on device from the interpolation tables."""
    n = jnp.clip(jnp.asarray(n, jnp.int32), 0, NMAX)
    x = jnp.clip(jnp.asarray(x, jnp.float64), 0.0, XB_MAX)
    # region A
    pos_a = x * ((NA_GRID - 1) / XA_MAX)
    h = _cubic_gather(ta, n, pos_a, NA_GRID)
    log_xh = jnp.where(x > 0, jnp.log(x / 2.0), -jnp.inf)
    val_a = h + n * log_xh - logfact[n]
    val_a = jnp.where((x == 0.0) & (n == 0), 0.0, val_a)
    # region B (grid uniform in sqrt x)
    u = jnp.sqrt(x)
    du = (math.sqrt(XB_MAX) - math.sqrt(XA_MAX)) / (NB_GRID - 1)
    pos_b = (u - math.sqrt(XA_MAX)) / du
    g = _cubic_gather(tb, n, pos_b, NB_GRID)
    val_b = g + x
    out = jnp.where(x <= XA_MAX, val_a, val_b)
    # Replicate the C implementation's overflow: bessi returns +inf once
    # exp(x) or the recurrence product exceeds DBL_MAX (bessel.c:399,520),
    # and the reference's +inf propagates into its DP.
    out = jnp.where((x >= 709.782712893384) | (out > 709.782712893384),
                    jnp.inf, out)
    # ... and its underflow: I_n below the smallest subnormal becomes 0,
    # whose C log() is -inf
    out = jnp.where(out < -745.13, -jnp.inf, out)
    return out


def logp_skellam_dev(k, lam, ta, tb, logfact):
    """-2*lam + log I_|k|(2*lam) elementwise (util.c:35 / prob.c:41)."""
    k = jnp.abs(jnp.asarray(k, jnp.int32))
    lam = jnp.asarray(lam, jnp.float64)
    out = -2.0 * lam + log_bessi_dev(k, 2.0 * lam, ta, tb, logfact)
    # orders beyond the table: treat as impossible transition
    out = jnp.where(k > NMAX, -jnp.inf, out)
    return out


# ---------------------------------------------------------------------------
# Packed single-gather variant.
#
# Fetching the four interpolation nodes as one contiguous 4-vector takes
# one gather instead of four.  ``build_packed_table`` lays the two regions of the Skellam
# table out as one (NMAX+1, NA_GRID+NB_GRID, 4) array whose [n, i] entry
# holds the 4 Lagrange nodes around grid index i, so one gather per
# evaluation replaces the 8 node gathers + logfact gather of the unpacked
# path (the logfact[n] term becomes a one-hot contraction over 385 rows,
# which is cheap vector work).  Values are bit-identical to
# ``logp_skellam_dev``: same nodes, same weight arithmetic, same special
# cases.


class PackedSkellam(NamedTuple):
    tab: jnp.ndarray      # (NMAX+1, NA_GRID+NB_GRID, 5) f64: 4 Lagrange
    #                       nodes + logfact[n] (rides the same gather, so
    #                       no 385-wide one-hot inside device loops)
    lf_n: jnp.ndarray     # (NMAX+1,) logfact restricted to table orders


_PACKED_CACHE: dict[int, "tuple"] = {}


def build_packed_skellam(nmax: int = NMAX):
    """Host-side packed layout of the Skellam interpolation tables."""
    if nmax in _PACKED_CACHE:
        return _PACKED_CACHE[nmax]
    st = build_skellam_tables(nmax)

    def pack(tab: np.ndarray) -> np.ndarray:
        npts = tab.shape[1]
        idx = np.arange(npts)
        i1 = np.clip(idx, 1, npts - 3)
        cols = np.stack([i1 - 1, i1, i1 + 1, i1 + 2], axis=-1)  # (npts, 4)
        return tab[:, cols]                                     # (n, npts, 4)

    packed = np.concatenate([pack(st.table_a), pack(st.table_b)], axis=1)
    lf_col = np.broadcast_to(
        st.logfact[: nmax + 1][:, None, None],
        (nmax + 1, packed.shape[1], 1))
    packed = np.concatenate([packed, lf_col], axis=2)
    out = (packed, st.logfact[: nmax + 1].copy())
    _PACKED_CACHE[nmax] = out
    return out


def _interp4(nodes, f):
    """4-point Lagrange combination, identical arithmetic to _cubic_gather."""
    w0 = -f * (f - 1.0) * (f - 2.0) / 6.0
    w1 = (f + 1.0) * (f - 1.0) * (f - 2.0) / 2.0
    w2 = -(f + 1.0) * f * (f - 2.0) / 2.0
    w3 = (f + 1.0) * f * (f - 1.0) / 6.0
    return (w0 * nodes[..., 0] + w1 * nodes[..., 1]
            + w2 * nodes[..., 2] + w3 * nodes[..., 3])


def split_gather(tab, n, idx, nsplit: int):
    """tab[n, idx] issued as ``nsplit`` independent sub-gathers.

    Inside device loops a single big gather serializes on its full
    latency every iteration; independent smaller gathers can overlap,
    so callers in scan bodies may split."""
    if nsplit <= 1:
        return tab[n, idx]
    shape = n.shape
    L = 1
    for d in shape:
        L *= d
    nf = n.reshape(L)
    idf = idx.reshape(L)
    part = -(-L // nsplit)
    outs = []
    for s in range(0, L, part):
        e = min(s + part, L)
        outs.append(tab[nf[s:e], idf[s:e]])
    flat = jnp.concatenate(outs, axis=0)
    return flat.reshape(shape + flat.shape[1:])


def skellam_args(k, lam):
    """(n, idx, f, in_a, x, k_abs) for a packed-table evaluation."""
    k = jnp.abs(jnp.asarray(k, jnp.int32))
    lam = jnp.asarray(lam, jnp.float64)
    x = jnp.clip(2.0 * lam, 0.0, XB_MAX)
    n = jnp.clip(k, 0, NMAX)

    pos_a = x * ((NA_GRID - 1) / XA_MAX)
    i1a = jnp.clip(jnp.floor(pos_a).astype(jnp.int32), 1, NA_GRID - 3)
    fa = pos_a - i1a
    u = jnp.sqrt(x)
    du = (math.sqrt(XB_MAX) - math.sqrt(XA_MAX)) / (NB_GRID - 1)
    pos_b = (u - math.sqrt(XA_MAX)) / du
    i1b = jnp.clip(jnp.floor(pos_b).astype(jnp.int32), 1, NB_GRID - 3)
    fb = pos_b - i1b

    in_a = x <= XA_MAX
    idx = jnp.where(in_a, i1a, NA_GRID + i1b)
    f = jnp.where(in_a, fa, fb)
    return n, idx, f, in_a, x, k


def skellam_value(nodes, ps: PackedSkellam, n, f, in_a, x, k, lam):
    """Assemble the log-Skellam value from gathered nodes (bit-identical
    arithmetic to logp_skellam_dev)."""
    val = _interp4(nodes, f)
    # logfact[n] rides the node gather as column 4 (same values as the
    # one-hot contraction it replaces — bit-identical)
    lf_n = nodes[..., 4]

    log_xh = jnp.where(x > 0, jnp.log(x / 2.0), -jnp.inf)
    val_a = val + n * log_xh - lf_n
    val_a = jnp.where((x == 0.0) & (n == 0), 0.0, val_a)
    val_b = val + x
    out = jnp.where(in_a, val_a, val_b)
    out = jnp.where((x >= 709.782712893384) | (out > 709.782712893384),
                    jnp.inf, out)
    out = jnp.where(out < -745.13, -jnp.inf, out)
    out = -2.0 * lam + out
    return jnp.where(k > NMAX, -jnp.inf, out)


def logp_skellam_packed(k, lam, ps: PackedSkellam, nsplit: int = 1):
    """Bit-identical to logp_skellam_dev; table read as ``nsplit``
    overlapping sub-gathers (see split_gather)."""
    lam = jnp.asarray(lam, jnp.float64)
    n, idx, f, in_a, x, ka = skellam_args(k, lam)
    nodes = split_gather(ps.tab, n, idx, nsplit)
    return skellam_value(nodes, ps, n, f, in_a, x, ka, lam)
