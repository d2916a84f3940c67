"""Multi-process data-parallel classification driver.

Device mapping of the reference's only parallelism (T pthreads over
contiguous read ranges, ClassPro.c:574-578 / io.c:175-176,353-354):

* each PROCESS (one per card) owns the contiguous read range [beg, end) given by
  the same ceil-partition the reference uses for threads;
* global estimation is either the shared ``.hist`` file (what the
  reference binary reads — exact parity) or, when requested, a ``psum``
  of per-host partial instance-count histograms over the device mesh
  (the one collective in the whole program — SURVEY §2.5/§5);
* every host classifies its shard with the pipelined TpuEngine stream
  and writes ``<out>.<pid>`` (io.c:139 temp-shard analog);
* process 0 concatenates the shards in read order (merge_files,
  io.c:70-112).

Cross-process classification needs ZERO communication — scaling is
bounded by host IO and read-length skew alone.

Run one process per card, ranks laid out host by host, e.g. four cards
of one host::

    for r in 0 1 2 3; do python -m classpro_tpu.parallel.driver \
        reads.fasta --coord localhost:8476 --nproc 4 --pid $r & done

Each process takes one card of its host (``local_card``), so that no
process reserves memory on the others.

Single-process invocation (``--nproc 1``, the default) needs no
coordinator and is what ``tests/test_distributed.py`` drives in
simulated multi-process mode.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np


def shard_range(nreads: int, nproc: int, pid: int) -> tuple[int, int]:
    """Contiguous ceil-partition of reads (io.c:175-176)."""
    per = (nreads + nproc - 1) // nproc
    beg = min(per * pid, nreads)
    return beg, min(beg + per, nreads)


def local_card(pid: int) -> int:
    """The card process ``pid`` takes on its host: the pid modulo the
    host's card count (the entries of CUDA_VISIBLE_DEVICES when set,
    else the /dev/nvidiaN nodes), so that on 4-card hosts pid 5 takes
    card 1.  With no count to be had, the pid itself."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        n = len([d for d in vis.split(",") if d.strip()])
    elif os.path.isdir("/dev"):
        n = sum(1 for f in os.listdir("/dev")
                if re.fullmatch(r"nvidia\d+", f))
    else:
        n = 0
    return pid % n if n else pid


def partial_instance_hist(profiles, low: int, high: int) -> np.ndarray:
    """Instance-count histogram of one read shard: positions of the
    shard's profiles bucketed by count, with the reference's boundary
    clamping (counts <= low into hist[low], >= high into hist[high] —
    libfastk.c:22-47 semantics).  Summing this over all shards equals
    Modify_Histogram's instance counts, because every k-mer instance of
    the dataset appears at exactly one profile position."""
    out = np.zeros(high + 1, np.int64)
    for p in profiles:
        if len(p):
            c = np.clip(p.astype(np.int64), low, high)
            out += np.bincount(c, minlength=high + 1)
    return out


def estimate_distributed(mesh, profiles, kmer: int, low: int = 1,
                         high: int = 32767, **kw):
    """Global model from per-host partial histograms + one psum
    (replaces process_global_hist's single-threaded load, hist.c:28-143,
    for the setting where no shared .hist exists)."""
    import dataclasses

    from classpro_tpu.constants import DEFAULTS
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import Histogram
    from classpro_tpu.parallel.mesh import psum_histogram

    @dataclasses.dataclass
    class _InstanceHist(Histogram):
        """Histogram whose buckets already ARE instance counts."""

        def instance_counts(self) -> np.ndarray:
            return self.hist.copy()

    part = partial_instance_hist(profiles, low, high)
    tot = np.asarray(psum_histogram(mesh, part))
    hist = _InstanceHist(kmer=kmer, low=low, high=high,
                         ilowcnt=int(tot[low]), ihighcnt=int(tot[high]),
                         hist=tot[low:high + 1])
    return build_global_model(hist, **kw)


def shard_records(path: str) -> int:
    """Count + structurally validate a shard file: 4-line fastq-like
    records, newline-terminated, last record's class line as long as its
    sequence line.  Returns -1 if the file is missing or malformed
    (e.g. a run killed mid-write).  Resume granularity per SURVEY §5:
    per-host shard files are the natural checkpoint unit."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return -1
    if not data:
        return 0
    if not data.endswith(b"\n"):
        return -1
    lines = data.split(b"\n")[:-1]
    if len(lines) % 4 != 0:
        return -1
    if lines and len(lines[-1]) != len(lines[-3]):
        return -1
    return len(lines) // 4


def _params_stamp(source: str, nproc: int, pid: int, coverage: int,
                  read_len: int, model_path: str | None) -> str:
    """Run-parameter fingerprint for shard resume: a stale shard
    produced with different -c/-r/-M (or a different partition) on the
    same dataset is structurally identical, so --resume must verify
    WHAT produced the shard, not just its shape (ADVICE r4).  The model
    file is hashed by content."""
    import hashlib

    key = f"{source}|{nproc}|{pid}|{coverage}|{read_len}|{model_path or ''}"
    if model_path and os.path.exists(model_path):
        with open(model_path, "rb") as f:
            key += "|" + hashlib.sha256(f.read()).hexdigest()
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def run_process(source: str, fastk_root: str | None, out: str | None,
                nproc: int = 1, pid: int = 0, coord: str | None = None,
                coverage: int = 0, read_len: int = 20000,
                model_path: str | None = None, batch_size: int = 200,
                verbose: bool = False, resume: bool = False,
                _skip_init: bool = False) -> str:
    """One host's share of the job.  Returns the shard (or merged) path.

    With ``resume=True``, a shard whose output file already exists,
    validates structurally, and holds exactly this range's record count
    is skipped (kill-and-rerun recovery; the reference simply overwrites
    its temp shards, io.c:139 — resume is a superset, off by default)."""
    if nproc > 1 and not _skip_init:
        import jax

        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=nproc, process_id=pid,
                                   local_device_ids=[local_card(pid)])

    from classpro_tpu.constants import DEFAULTS
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.classfile import class_header
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx_checked
    from classpro_tpu.tpu.engine import TpuEngine

    root = source
    for ext in (".fastq", ".fasta", ".fq", ".fa",
                ".fastq.gz", ".fasta.gz", ".fq.gz", ".fa.gz"):
        if source.endswith(ext):
            root = source[: -len(ext)]
            break
    fk_root = fastk_root or root
    final = out or root + ".class"

    gm = build_global_model(load_histogram(fk_root), coverage=coverage,
                            read_len=read_len, model_path=model_path)
    P = open_profiles(fk_root)
    beg, end = shard_range(P.nreads, nproc, pid)
    eng = TpuEngine(gm, batch_size=batch_size)

    shard = final + (f".{pid}" if nproc > 1 else "")
    stamp = _params_stamp(source, nproc, pid, coverage, read_len,
                          model_path)
    stamp_path = shard + ".params"
    if resume and shard_records(shard) == end - beg:
        try:
            with open(stamp_path) as f:
                prior = f.read().strip()
        except OSError:
            prior = None
        if prior == stamp:
            if verbose:
                print(f"[{pid}/{nproc}] resume: {shard} complete "
                      f"({end - beg} reads), skipping", file=sys.stderr)
            return shard
        if verbose:
            print(f"[{pid}/{nproc}] resume: {shard} was produced with "
                  f"different parameters — reclassifying",
                  file=sys.stderr)
    recs: list = []

    K = gm.kmer

    def _flush(buf, rid0):
        recs.append(buf)
        plens = [max(len(r.seq) - K + 1, 0) for r in buf]
        return ([r.seq for r in buf],
                P.fetch_batch(list(range(rid0, rid0 + len(buf))), plens))

    def chunks():
        buf: list = []
        for rid, rec in enumerate(read_fastx_checked(source, DEFAULTS.max_read_len)):
            if rid < beg:
                continue
            if rid >= end:
                break
            buf.append(rec)
            if len(buf) >= batch_size:
                yield _flush(buf, rid - len(buf) + 1)
                buf = []
        if buf:
            yield _flush(buf, end - len(buf))

    with open(shard, "w") as f:
        for classes in eng.classify_stream(chunks(), sort_window=8):
            chunk_recs = recs.pop(0)
            for rec, cls in zip(chunk_recs, classes):
                f.write(f"{class_header(rec.name, rec.comment)}\n"
                        f"{rec.seq}\n+\n{cls}\n")
    with open(stamp_path, "w") as f:
        f.write(stamp + "\n")
    if verbose:
        print(f"[{pid}/{nproc}] wrote {shard} (reads {beg}..{end})",
              file=sys.stderr)
    return shard


def merge_shards(final: str, nproc: int,
                 expected: list[int] | None = None) -> None:
    """Read-order concatenation of per-host shards (io.c:70-112).

    ``expected`` (per-shard record counts from the same ceil-partition
    every process used) makes the merge validate completeness first: a
    missing, truncated, or short shard aborts the merge instead of
    silently producing a short output file."""
    paths = [f"{final}.{p}" for p in range(nproc)]
    if expected is not None:
        for p, (path, want) in enumerate(zip(paths, expected)):
            got = shard_records(path)
            if got != want:
                raise RuntimeError(
                    f"shard {p} ({path}) incomplete: {got} records, "
                    f"expected {want} — not merging")
    from classpro_tpu.io.merge import merge_files

    merge_files(final, paths)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source")
    ap.add_argument("-N", "--fastk-root")
    ap.add_argument("-o", "--output")
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--pid", type=int,
                    default=int(os.environ.get("JAX_PROCESS_ID", 0)))
    ap.add_argument("--coord", help="coordinator host:port (multi-process)")
    ap.add_argument("-c", "--coverage", type=int, default=0)
    ap.add_argument("-r", "--read-len", type=int, default=20000)
    ap.add_argument("-M", "--model")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip shards whose output file is already "
                         "complete (kill-and-rerun recovery)")
    a = ap.parse_args(argv)
    shard = run_process(a.source, a.fastk_root, a.output, a.nproc, a.pid,
                        a.coord, a.coverage, a.read_len, a.model,
                        verbose=a.verbose, resume=a.resume)
    if a.nproc > 1:
        # cross-process barrier before the merge: one psum over the mesh
        from classpro_tpu.parallel.mesh import (data_parallel_mesh,
                                                psum_histogram)

        psum_histogram(data_parallel_mesh(), np.ones(1, np.int64))
        if a.pid == 0:
            from classpro_tpu.io.fastk import open_profiles

            fk = a.fastk_root
            if not fk:
                fk = a.source
                for ext in (".fastq", ".fasta", ".fq", ".fa",
                            ".fastq.gz", ".fasta.gz", ".fq.gz", ".fa.gz"):
                    if a.source.endswith(ext):
                        fk = a.source[: -len(ext)]
                        break
            nreads = open_profiles(fk).nreads
            expected = [e - b for b, e in
                        (shard_range(nreads, a.nproc, p)
                         for p in range(a.nproc))]
            merge_shards(shard.rsplit(".", 1)[0], a.nproc, expected)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
