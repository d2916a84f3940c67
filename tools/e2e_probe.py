#!/usr/bin/env python3
"""Where does bench's e2e-minus-steady gap go? (VERDICT r3 #5)

The chunk generator runs on a bounded prefetch thread and every heavy
piece of input production (gzip inflate + FASTA parse + FASTK decode)
is GIL-releasing C, so it should overlap the device wait.  This probe
measures where the time actually sits:

* per-pass producer work time (inside the prefetch thread);
* producer blocked-on-full-queue time vs consumer blocked-on-empty
  time (who starves whom);
* stream wall per chunk for three input variants:
    full      gzip + parse + decode inside the window (bench e2e)
    nogz      pre-inflated .fasta bytes (isolates gzip)
    decode    pre-parsed records, only profile decode inside
    steady    everything pre-staged (bench steady framing)

Run on an IDLE machine.  Usage: python3 tools/e2e_probe.py [--reps N]
"""

from __future__ import annotations

import argparse
import gzip
import os
import pathlib
import sys
import threading
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FX = REPO / "tests" / "fixtures" / "medium"


class Meter:
    def __init__(self):
        self.produce = 0.0   # producer CPU-side work
        self.p_block = 0.0   # producer blocked on full queue
        self.c_block = 0.0   # consumer blocked on empty queue
        self.passes = 0


def metered_prefetch(gen_factory, reps, depth, meter):
    """_prefetch_iter with instrumentation."""
    import queue

    q = queue.Queue(maxsize=depth)
    END = object()

    def produce():
        for _ in range(reps):
            t0 = time.perf_counter()
            for item in gen_factory():
                meter.produce += time.perf_counter() - t0
                t0 = time.perf_counter()
                q.put(item)
                meter.p_block += time.perf_counter() - t0
                t0 = time.perf_counter()
            meter.produce += time.perf_counter() - t0
            meter.passes += 1
            t0 = time.perf_counter()
        q.put(END)

    th = threading.Thread(target=produce, daemon=True)
    th.start()
    while True:
        t0 = time.perf_counter()
        item = q.get()
        meter.c_block += time.perf_counter() - t0
        if item is END:
            return
        yield item


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=200)
    a = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import TpuEngine

    gm = build_global_model(load_histogram(str(FX / "reads")))
    P = open_profiles(str(FX / "reads"))
    reads = list(read_fastx(str(FX / "reads.fasta.gz")))
    profs = [P.fetch(i) for i in range(P.nreads)]
    seqs = [r.seq for r in reads]
    K = gm.kmer
    B = a.batch
    total_kmers = sum(len(p) for p in profs)

    # pre-inflated copy for the nogz variant
    raw = gzip.decompress((FX / "reads.fasta.gz").read_bytes())
    plain = "/tmp/e2e_probe_reads.fasta"
    with open(plain, "wb") as f:
        f.write(raw)

    eng = TpuEngine(gm, batch_size=B)

    def gen_full():
        buf, rid = [], 0
        for rec in read_fastx(str(FX / "reads.fasta.gz")):
            buf.append(rec.seq)
            rid += 1
            if len(buf) >= B:
                plens = [max(len(s) - K + 1, 0) for s in buf]
                yield buf, P.fetch_batch(
                    list(range(rid - len(buf), rid)), plens)
                buf = []
        if buf:
            plens = [max(len(s) - K + 1, 0) for s in buf]
            yield buf, P.fetch_batch(list(range(rid - len(buf), rid)),
                                     plens)

    def gen_nogz():
        buf, rid = [], 0
        for rec in read_fastx(plain):
            buf.append(rec.seq)
            rid += 1
            if len(buf) >= B:
                plens = [max(len(s) - K + 1, 0) for s in buf]
                yield buf, P.fetch_batch(
                    list(range(rid - len(buf), rid)), plens)
                buf = []
        if buf:
            plens = [max(len(s) - K + 1, 0) for s in buf]
            yield buf, P.fetch_batch(list(range(rid - len(buf), rid)),
                                     plens)

    def gen_decode():
        for i in range(0, len(seqs), B):
            sub = seqs[i:i + B]
            plens = [max(len(s) - K + 1, 0) for s in sub]
            yield sub, P.fetch_batch(list(range(i, i + len(sub))), plens)

    def gen_steady():
        for i in range(0, len(seqs), B):
            yield seqs[i:i + B], profs[i:i + B]

    # warm up (compile + first-execution penalty)
    for _ in eng.classify_stream(gen_steady()):
        pass

    nchunks = (len(seqs) + B - 1) // B
    print(f"{nchunks} chunks/pass, {total_kmers/1e6:.2f} Mk/pass, "
          f"reps={a.reps}")
    for name, gf in (("steady", gen_steady), ("decode", gen_decode),
                     ("nogz", gen_nogz), ("full", gen_full)):
        for trial in range(2):
            m = Meter()
            t0 = time.perf_counter()
            for _ in eng.classify_stream(
                    metered_prefetch(gf, a.reps, 2, m), prefetch=0):
                pass
            wall = time.perf_counter() - t0
            rate = a.reps * total_kmers / wall / 1e6
            per_chunk = wall / (a.reps * nchunks) * 1e3
            print(f"{name:7s} trial{trial}: {rate:6.1f} Mk/s  "
                  f"{per_chunk:6.2f} ms/chunk  "
                  f"produce {m.produce/a.reps*1e3:6.2f} ms/pass  "
                  f"p_block {m.p_block/a.reps*1e3:6.2f}  "
                  f"c_block {m.c_block/a.reps*1e3:6.2f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
