"""Batched sequence context on device (ref context.c).

Key structural insight (validated element-exact against the oracle
transcription): the reference's left-context recurrences are strided
reset-scans, and its right-context back-fill is *exactly* the same
recurrence evaluated on the reversed sequence.  So the whole stage is:

  lctx = reset_scans(seq);  rctx = reverse(reset_scans(reverse(seq)))

with three boundary overrides (context.c:83, ClassPro.c:139-140).
Everything is `(B, L)`-vectorized cumulative-max scans — no sequential
per-base loop survives.

Caveat: for low-complexity runs longer than 127 units the reference's
back-fill only covers a suffix (stale-memory bug in C); such reads are
detected by the engine and routed to the exact oracle (vanishingly rare
in real HiFi data).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HP, DS, TS = 0, 1, 2


def _reset_scan_cap(reset: jnp.ndarray, v0: jnp.ndarray) -> jnp.ndarray:
    """v[t] = v0[last_reset] + (t - last_reset), capped at 127, along axis -1.

    ``reset`` marks chain restarts; every chain's first element must be a
    reset (guaranteed by construction)."""
    n = reset.shape[-1]
    t = jnp.arange(n, dtype=jnp.int32)
    last_reset = jax.lax.cummax(jnp.where(reset, t, -1), axis=reset.ndim - 1)
    safe = jnp.maximum(last_reset, 0)
    base = jnp.take_along_axis(v0, safe, axis=-1)
    return jnp.minimum(base + (t - last_reset), 127)


def _scans(a: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Forward lctx scans over (B, L) byte codes."""
    B, L = a.shape
    idx = jnp.arange(L, dtype=jnp.int32)

    hp_at = jnp.concatenate(
        [jnp.zeros((B, 1), bool), a[:, 1:] == a[:, :-1]], axis=1)
    per2 = jnp.concatenate(
        [jnp.zeros((B, 3), bool),
         (a[:, :-3] == a[:, 2:-1]) & (a[:, 1:-2] == a[:, 3:])], axis=1)
    hp2 = jnp.concatenate(
        [jnp.zeros((B, 2), bool),
         (a[:, 2:] == a[:, 1:-1]) & (a[:, 1:-1] == a[:, :-2])], axis=1)
    per3 = jnp.concatenate(
        [jnp.zeros((B, 5), bool),
         (a[:, :-5] == a[:, 3:-2]) & (a[:, 1:-4] == a[:, 4:-1])
         & (a[:, 2:-3] == a[:, 5:])], axis=1)

    # HP: plain reset-scan (run length ending at i, capped)
    last_false = jax.lax.cummax(jnp.where(~hp_at, idx, -1), axis=1)
    lhp = jnp.minimum(idx - last_false + 1, 127)

    # DS / TS: strided chains with value-carrying resets
    def strided(stride: int, resets, v0s):
        out = jnp.zeros((B, L), jnp.int32)
        pad = (-L) % stride
        rs = jnp.pad(resets, ((0, 0), (0, pad)), constant_values=True)
        vs = jnp.pad(v0s, ((0, 0), (0, pad)))
        n = rs.shape[1] // stride
        rs = rs.reshape(B, n, stride)
        vs = vs.reshape(B, n, stride)
        # chains live along axis=1 for each phase p = axis2
        rs = jnp.swapaxes(rs, 1, 2).reshape(B * stride, n)
        vs = jnp.swapaxes(vs, 1, 2).reshape(B * stride, n)
        v = _reset_scan_cap(rs, vs)
        v = jnp.swapaxes(v.reshape(B, stride, n), 1, 2).reshape(B, n * stride)
        return v[:, :L]

    lds = strided(2, hp_at | ~per2, jnp.where(hp_at, 0, 1).astype(jnp.int32))
    lts = strided(3, hp2 | ~per3, jnp.where(hp2, 0, 1).astype(jnp.int32))
    return lhp.astype(jnp.int32), lds, lts


def batch_context(seq: jnp.ndarray, lens: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(B, L) byte codes + (B,) lengths -> lctx, rctx of shape (B, L, 3).

    Positions >= lens are garbage (masked downstream)."""
    B, L = seq.shape
    idx = jnp.arange(L, dtype=jnp.int32)

    lhp, lds, lts = _scans(seq)
    # lctx boundary (ClassPro.c:139-140): lctx[0] = (1,0,0); lctx[1][TS] = 0
    lds = lds.at[:, 0].set(0)
    lts = lts.at[:, 0].set(0)
    if L > 1:
        lts = lts.at[:, 1].set(0)
    lctx = jnp.stack([lhp, lds, lts], axis=-1)

    # reversed-within-length rows
    ridx = jnp.clip(lens[:, None] - 1 - idx[None, :], 0, L - 1)
    rev = jnp.take_along_axis(seq, ridx, axis=1)
    rhp_r, rds_r, rts_r = _scans(rev)
    rds_r = rds_r.at[:, 0].set(0)
    rts_r = rts_r.at[:, 0].set(0)
    if L > 1:
        rts_r = rts_r.at[:, 1].set(0)

    def unrev(x):
        return jnp.take_along_axis(x, ridx, axis=1)

    rhp, rds, rts = unrev(rhp_r), unrev(rds_r), unrev(rts_r)
    # forced zeros at the tail (context.c:83); note the reversed scan
    # already yields (1,0,0)-style boundary values at position len-1 via
    # the lctx[0] override, and 0 at len-2 for TS via the lctx[1] override,
    # matching the C forced writes:
    rctx = jnp.stack([rhp, rds, rts], axis=-1)
    return lctx, rctx


def max_run_exceeds(lctx: jnp.ndarray, rctx: jnp.ndarray, lens: jnp.ndarray,
                    cap: int = 127) -> jnp.ndarray:
    """(B,) bool: any context run at the 127 cap (route such reads to the
    oracle engine — the reference's back-fill is stale-memory there)."""
    L = lctx.shape[1]
    valid = jnp.arange(L)[None, :] < lens[:, None]
    m1 = jnp.max(jnp.where(valid[..., None], lctx, 0), axis=(1, 2))
    m2 = jnp.max(jnp.where(valid[..., None], rctx, 0), axis=(1, 2))
    return jnp.maximum(m1, m2) >= cap
