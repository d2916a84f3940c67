#!/usr/bin/env python3
"""Time the production rel device program under one CP_* ablation env.

Stages + packs real chunks from the medium fixture, then times the
(R, max_m) bucket's AOT executable serially INCLUDING the result fetch
(the fetch waits for the program to finish).  Run it
once per env from a shell loop; the switches are read at import time:

  python3 tools/ablate_device.py                      # full program
  CP_ABLATE=notb python3 tools/ablate_device.py       # no traceback
  CP_ABLATE=nodp,notb python3 tools/ablate_device.py  # fixed cost only
  CP_STUB_GATHER=1 python3 tools/ablate_device.py     # no Skellam gather
  CP_NO_GUARD=1 python3 tools/ablate_device.py        # no guard ops

Output is wrong under any switch — this is measurement only
(VERDICT r2 #1 cost attribution).
"""

from __future__ import annotations

import os
import pathlib
import statistics
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> None:
    import jax

    jax.config.update("jax_enable_x64", True)

    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import TpuEngine

    fx = REPO / "tests" / "fixtures" / "medium"
    gm = build_global_model(load_histogram(str(fx / "reads")))
    P = open_profiles(str(fx / "reads"))
    reads = list(read_fastx(str(fx / "reads.fasta.gz")))
    profs = [P.fetch(i) for i in range(P.nreads)]
    seqs = [r.seq for r in reads]

    eng = TpuEngine(gm, batch_size=200)
    blobs = []
    for i0 in range(0, len(seqs), 200):
        st = eng._stage(seqs[i0:i0 + 200], profs[i0:i0 + 200])
        if "_plens" not in st:
            continue
        fb, ib = eng._pack_st(st, st["_R"], st["_mm"])
        blobs.append((st["_R"], st["_mm"], fb, ib))

    tag = (os.environ.get("CP_ABLATE", "") or "full",
           "stub_gather" if os.environ.get("CP_STUB_GATHER") == "1" else "",
           "no_guard" if os.environ.get("CP_NO_GUARD") == "1" else "")
    tag = "+".join(t for t in tag if t)
    reps = int(os.environ.get("ABLATE_REPS", "10"))

    for R, mm, fb, ib in blobs:
        ex = eng._rel_exec(R, mm)

        def run():
            np.asarray(ex(fb, ib))   # single fused output blob

        run()  # warm: build + first execution
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            ts.append(time.perf_counter() - t0)
        print(f"{tag:24s} R={R} max_m={mm} "
              f"median {statistics.median(ts) * 1e3:7.2f} ms  "
              f"min {min(ts) * 1e3:7.2f} ms", flush=True)


if __name__ == "__main__":
    main()
