"""Per-base sequence context: homopolymer / dinucleotide / trinucleotide
run lengths (ref context.c:8-108).

``lctx[i][t]`` is the length (in units) of the type-t low-complexity run
*ending* at base i; ``rctx[i][t]`` the length of the run *starting* at i.
Both capped at 127.  Wall detection consumes them shifted: a DROP at
profile position p looks at ``lctx[p + K - 2]``, a GAIN at ``rctx[p]``
(ClassPro.c:141-142: ctx[DROP] = _lctx + K - 2, ctx[GAIN] = rctx).

This module holds the faithful transcription of the reference pass
(the oracle); the batched/vectorized form lives in the device engine and is
tested element-exact against this one.

Note on >127-long runs: the reference back-fills ``rctx`` only over the
last ``lctx[end]`` (capped at 127) positions of a run, so for runs longer
than 127 the uncovered prefix keeps values from the previous read on the
same thread (a latent stale-read in the reference).  We instead propagate
the mirrored cap value deterministically; divergence is only possible for
homopolymer/satellite runs >127 bases, which do not occur in real HiFi
data and are excluded from the fixtures.
"""

from __future__ import annotations

import numpy as np

HP, DS, TS = 0, 1, 2


def seq_context(seq: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Exact transcription of calc_seq_context (context.c:8-108)."""
    rlen = len(seq)
    lctx = np.zeros((rlen, 3), dtype=np.int32)
    rctx = np.zeros((rlen, 3), dtype=np.int32)
    lctx[0][HP] = 1  # ClassPro.c:139-140
    rlenm1 = rlen - 1
    s = seq

    in_ds = in_ts = 0
    for i in range(1, rlen):
        in_hp = 1 if s[i - 1] == s[i] else 0
        in_ds = in_ts = 0

        if in_hp:
            lctx[i][HP] = min(lctx[i - 1][HP] + 1, 127)
            lctx[i][DS] = rctx[i - 1][DS] = 0
        else:
            lctx[i][HP] = 1
            lctx[i][DS] = rctx[i - 1][DS] = 1
            n = 0
            for j in range(i - lctx[i - 1][HP], i):
                rctx[j][HP] = lctx[i - 1 - n][HP]
                n += 1
            if i >= 3 and s[i - 3] == s[i - 1] and s[i - 2] == s[i]:
                lctx[i][DS] = min(lctx[i - 2][DS] + 1, 127)
                in_ds = 1

        if not in_ds:
            l = i - 1
            while lctx[l][DS] > 1:
                l -= 1
            if l < i - 1:
                n = 0
                for j in range(l - 1, i):
                    rctx[j - 1][DS] = lctx[i - 1 - n][DS]
                    n += 1

        if i >= 2:
            if in_hp and s[i - 2] == s[i - 1]:
                lctx[i][TS] = rctx[i - 2][TS] = 0
            elif i >= 5 and s[i - 5] == s[i - 2] and s[i - 4] == s[i - 1] and s[i - 3] == s[i]:
                lctx[i][TS] = min(lctx[i - 3][TS] + 1, 127)
                in_ts = 1
            else:
                lctx[i][TS] = rctx[i - 1][TS] = rctx[i - 2][TS] = 1

            if not in_ts:
                l = i - 1
                while lctx[l][TS] > 1:
                    l -= 1
                if l < i - 1:
                    n = 0
                    for j in range(l - 2, i):
                        rctx[j - 2][TS] = lctx[i - 1 - n][TS]
                        n += 1

    n = 0
    for j in range(rlen - lctx[rlenm1][HP], rlen):
        rctx[j][HP] = lctx[rlenm1 - n][HP]
        n += 1

    if in_ds:
        l = rlenm1
        while lctx[l][DS] > 1:
            l -= 1
        if l < rlenm1:
            n = 0
            for j in range(l - 1, rlen):
                rctx[j - 1][DS] = lctx[rlenm1 - n][DS]
                n += 1

    if in_ts:
        l = rlenm1
        while lctx[l][TS] > 1:
            l -= 1
        if l < rlenm1:
            n = 0
            for j in range(l - 2, rlen):
                rctx[j - 2][TS] = lctx[rlenm1 - n][TS]
                n += 1

    rctx[rlenm1][DS] = rctx[rlenm1][TS] = rctx[rlen - 2][TS] = 0
    return lctx, rctx
