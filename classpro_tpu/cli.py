"""Command-line interface.

Subcommands mirror the reference tool family:

* ``classify``   — ClassPro equivalent (ClassPro.c): E/H/D/R per k-mer
* ``classgs``    — global-threshold classifier (ClassGS.c)
* ``prof2class`` — ground truth from a relative profile (prof2class.c)
* ``class2acc``  — accuracy evaluation (class2acc.c)
* ``simulate``   — synthetic dataset generator (replaces test/0-download.sh)
"""

from __future__ import annotations

import argparse
import os
import struct
import sys


def _root_of(source: str) -> str:
    for ext in (".fastq", ".fasta", ".fq", ".fa",
                ".fastq.gz", ".fasta.gz", ".fq.gz", ".fa.gz"):
        if source.endswith(ext):
            return source[: -len(ext)]
    return source


def _seed_finder():
    """C++ seed selection when the native library is available
    (csrc cp_find_seeds, ~50x the Python port), else the Python oracle.
    Returns find(seq, classes_tail, profile, K) -> (labels, rep_intvls);
    one persistent workspace (reference -T1 stale-slot semantics)."""
    try:
        from classpro_tpu.native import NativeSeedWorkspace

        ws = NativeSeedWorkspace()
        return lambda seq, cls, prof, K: ws.find_seeds(seq, cls, prof, K)
    except Exception:
        from classpro_tpu.seeds import Workspace, find_seeds

        ws = Workspace()
        return lambda seq, cls, prof, K: find_seeds(seq, cls, prof, K, ws)


def _classify_db(args) -> int:
    """DAZZ .db/.dam input mode: classify + write the .class file and
    the DAZZ-format .class/.rep tracks (ClassPro.c:289-304, io.c)."""
    import numpy as np

    from classpro_tpu.io.dazz import (DazzDB, IntPairTrackWriter,
                                      TrackWriter, compress_codes)
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.tpu.engine import TpuEngine

    db = DazzDB(args.source)
    fk_root = args.fastk_root or db.root
    out = args.output or db.root + ".class"
    gm = build_global_model(load_histogram(fk_root),
                            coverage=args.coverage,
                            read_len=args.read_len,
                            model_path=args.model)
    P = open_profiles(fk_root)
    eng = TpuEngine(gm, threads=args.threads, verbose=args.verbose)
    K = gm.kmer
    ctos = np.zeros(256, np.uint8)        # const.c stoc order E,R,H,D
    for code, ch in enumerate(b"ERHD"):
        ctos[ch] = code

    tw = TrackWriter(db.root, "class", db.nreads, 8)
    rw = IntPairTrackWriter(db.root, "rep", db.nreads)
    if args.seeds:
        find_seeds = _seed_finder()
    bs = 200
    spans = [(lo, min(lo + bs, db.nreads))
             for lo in range(0, db.nreads, bs)]
    # bounded by construction: classify_stream pulls this generator
    # synchronously and keeps <= 3 chunks in flight, and the consumer
    # below pops one entry per yielded result — so <= 4 entries live
    cache: dict = {}

    def chunk_iter():
        for lo, hi in spans:
            seqs = [db.load_read(i) for i in range(lo, hi)]
            profs = [P.fetch(i) for i in range(lo, hi)]
            for j, p in enumerate(profs):  # ClassPro.c:184-187 rlen check
                want = max(len(seqs[j]) - K + 1, 0)
                if len(p) != want:
                    raise ValueError(
                        f"Read {lo + j}: rlen ({len(seqs[j])}) != "
                        f"plen+Km1 ({len(p) + K - 1}) — profile/read "
                        f"mismatch")
            cache[lo] = (seqs, profs)
            yield seqs, profs

    stream = eng.classify_stream(chunk_iter())
    with open(out, "w") as cf:
        for (lo, hi), classes in zip(spans, stream):
            seqs, profs = cache.pop(lo)
            for j, i in enumerate(range(lo, hi)):
                cf.write(f"{db.header(i)}\n{seqs[j]}\n+\n{classes[j]}\n")
                body = classes[j]
                if args.seeds and len(profs[j]) > 0:
                    labels, rints = find_seeds(
                        seqs[j], classes[j][K - 1:], profs[j], K)
                    body = "N" * (K - 1) + labels
                    rw.add(rints)
                codes = ctos[np.frombuffer(body.encode(), np.uint8)]
                tw.add(compress_codes(codes))
    tw.close()
    rw.close()
    db.close()
    if args.verbose:
        print(f"wrote {out} + .class/.rep tracks", file=sys.stderr)
    return 0


# Supported input extensions (ClassPro.h:326 EXT table, same probe order)
_EXTS = (".db", ".dam", ".fastq", ".fasta", ".fq", ".fa",
         ".fastq.gz", ".fasta.gz", ".fq.gz", ".fa.gz")


def _check_classify_args(args) -> None:
    """The reference's argument/input refusal envelope
    (ClassPro.c:348-500 parse_arg + gene_core.h:46-68 ARG_* macros):
    -T positive, -c non-negative, -r positive, -P an existing directory,
    the input openable under a known extension.  Each violation exits 1
    with one stderr line, like the C."""
    if args.threads <= 0:
        raise ValueError(f"Number of threads must be positive "
                         f"({args.threads})")
    if args.coverage < 0:
        raise ValueError(f"Estimated k-mer coverage must be non-negative "
                         f"({args.coverage})")
    if args.read_len <= 0:
        raise ValueError(f"Average read length must be positive "
                         f"({args.read_len})")
    if not os.path.isdir(args.tmp_dir):
        raise ValueError(f"-P option: cannot open directory {args.tmp_dir}")
    # The reference's EXT probe (ClassPro.c:413-423): for each known
    # extension IN TABLE ORDER, Root-strip it from the argument (when
    # present) and try opening root+ext — so a bare root like 'reads'
    # with 'reads.fasta' on disk is accepted, exactly like the C.
    for ext in _EXTS:
        root = (args.source[: -len(ext)]
                if args.source.endswith(ext) else args.source)
        cand = root + ext
        if os.path.exists(cand):
            args.source = cand
            break
    else:
        raise ValueError(f"Cannot open {args.source} as a .db|.dam or "
                         f".f{{ast}}[aq][.gz] file")


def cmd_serve(args: argparse.Namespace) -> int:
    from classpro_tpu.backend import require_gpu
    from classpro_tpu.serve import serve

    require_gpu()

    shapes = tuple(tuple(int(x) for x in s.lower().split("x"))
                   for s in args.warmup_shape)
    return serve(args.socket, warmup_root=args.warmup_root,
                 warmup_shapes=shapes, verbose=args.verbose)


def cmd_classify(args: argparse.Namespace) -> int:
    from classpro_tpu.io.classfile import write_class
    from classpro_tpu.timing import PhaseTimer

    _check_classify_args(args)
    if getattr(args, "server", None):
        # delegate to the warm daemon; unsupported-by-serve options are
        # refused here rather than silently dropped
        from classpro_tpu.serve import request

        if args.seeds or args.engine == "exact" or \
                args.source.endswith((".db", ".dam")):
            raise ValueError("--server supports plain FASTX classify "
                             "jobs (no -s/--engine exact/.db/.dam)")
        root = _root_of(args.source)
        rep = request(args.server, {
            "cmd": "classify", "source": os.path.abspath(args.source),
            "fastk_root": os.path.abspath(args.fastk_root or root),
            "output": os.path.abspath(args.output or root + ".class"),
            "coverage": args.coverage, "read_len": args.read_len,
            "model": args.model and os.path.abspath(args.model),
            "threads": args.threads, "warmup": args.warmup,
        }, timeout=30.0)
        if not rep.get("ok"):
            print(f"server error: {rep.get('error')}", file=sys.stderr)
            return 1
        if args.verbose:
            print(f"server: {rep['reads']} reads in {rep['wall_s']}s "
                  f"-> {rep['output']} (warm shapes "
                  f"{rep['warm_shapes']})", file=sys.stderr)
        return 0
    timer = PhaseTimer()
    if args.source.endswith((".dam", ".db")):
        rc = _classify_db(args)
        if args.verbose:
            print(timer.report(total=True), file=sys.stderr)
        return rc

    root = _root_of(args.source)
    fk_root = args.fastk_root or root
    out = args.output or root + ".class"
    if getattr(args, "pmm", False):
        from classpro_tpu.estimation import build_global_model
        from classpro_tpu.io.fastk import load_histogram, open_profiles
        from classpro_tpu.pmm import PmmModel

        import numpy as np

        hist = load_histogram(fk_root)
        gm = build_global_model(hist, coverage=args.coverage,
                                read_len=args.read_len,
                                model_path=args.model)
        by_count = np.zeros(hist.high + 1, np.int64)
        by_count[hist.low: hist.high + 1] = hist.instance_counts()
        pm = PmmModel(gm, by_count)
        P = open_profiles(fk_root)
        for rid in range(P.nreads):
            n, lam = pm.pmm_vi(P.fetch(rid))
            print(f"read {rid}: N={n} lambda=({lam[0]:.1f},{lam[1]:.1f})",
                  file=sys.stderr)
    if args.engine == "exact":
        from classpro_tpu.exact.pipeline import classify_file

        recs = classify_file(args.source, fk_root, coverage=args.coverage,
                             read_len=args.read_len, model_path=args.model)
    else:
        from classpro_tpu.tpu.engine import classify_file_tpu

        eng_stats: dict = {}
        recs = classify_file_tpu(args.source, fk_root, coverage=args.coverage,
                                 read_len=args.read_len, model_path=args.model,
                                 threads=args.threads, verbose=args.verbose,
                                 warmup=args.warmup,
                                 devices=getattr(args, "devices", 0),
                                 stats_out=eng_stats)
    if args.seeds:
        from classpro_tpu.io.fastk import open_profiles

        find_seeds = _seed_finder()
        P = open_profiles(fk_root)
        K = P.kmer
        seed_path = out + ".seeds"
        rep_path = out + ".rep"

        def with_seeds(records):
            with open(seed_path, "w") as sf, open(rep_path, "w") as rf:
                for rid, rec in enumerate(records):
                    prof = P.fetch(rid)
                    if len(prof) > 0:
                        labels, rints = find_seeds(
                            rec.seq, rec.classes[K - 1:], prof, K)
                        sf.write(rec.header + "\n" + "N" * (K - 1)
                                 + labels + "\n")
                        for b, e in rints:
                            rf.write(f"{rid}\t{b}\t{e}\n")
                    else:
                        sf.write(rec.header + "\n"
                                 + "N" * len(rec.seq) + "\n")
                    yield rec

        recs = with_seeds(recs)
    stats = {"kmers": 0, "reads": 0}

    def counted(records):
        for rec in records:
            stats["kmers"] += len(rec.classes) - rec.classes.count("N")
            stats["reads"] += 1
            yield rec

    import contextlib
    import time as _time

    prof_ctx = contextlib.nullcontext()
    if getattr(args, "jax_profile", None):
        import jax

        prof_ctx = jax.profiler.trace(args.jax_profile)
        print(f"writing xprof trace to {args.jax_profile}", file=sys.stderr)
    t0 = _time.time()
    with prof_ctx:
        write_class(out, counted(recs))
    wall = _time.time() - t0
    if getattr(args, "stats_json", None):
        import json as _json

        rec = dict(wall_s=round(wall, 2), **stats)
        if args.engine == "tpu":
            rec.update(eng_stats)
        with open(args.stats_json, "w") as f:
            _json.dump(rec, f)
    if args.verbose:
        if args.engine == "tpu":
            print(f"platform {eng_stats['platform']} "
                  f"({eng_stats['device_kind']} x"
                  f"{eng_stats['device_count']}), wall stage "
                  f"{eng_stats['wall_stage']}", file=sys.stderr)
        print(f"wrote {out}", file=sys.stderr)
        print(f"{stats['reads']} reads, {stats['kmers']} k-mers in "
              f"{wall:.2f}s = {stats['kmers'] / max(wall, 1e-9) / 1e6:.2f} "
              f"Mk-mers/s (incl. parse+decode; cold-start compile "
              f"excluded only via --warmup)", file=sys.stderr)
        print(timer.report(total=True), file=sys.stderr)
    return 0


def cmd_debug_read(args: argparse.Namespace) -> int:
    from classpro_tpu.tools.debug_read import debug_read

    same = debug_read(args.source, args.read_id,
                      fastk_root=args.fastk_root, coverage=args.coverage,
                      read_len=args.read_len, model_path=args.model)
    return 0 if same else 2


def cmd_classgs(args: argparse.Namespace) -> int:
    from classpro_tpu.io.classfile import write_class
    from classpro_tpu.tools.classgs import classify_gs_file

    root = _root_of(args.source)
    out = args.output or root + ".GS.class"
    write_class(out, classify_gs_file(args.source, args.fastk_root or root,
                                      (args.eh, args.hd, args.dr)))
    return 0


def cmd_prof2class(args: argparse.Namespace) -> int:
    from classpro_tpu.io.classfile import write_class
    from classpro_tpu.tools.prof2class import prof2class_file

    root = _root_of(args.source)
    out = args.output or root + ".truth.class"
    write_class(out, prof2class_file(args.truth_prof, args.source))
    return 0


def cmd_class2acc(args: argparse.Namespace) -> int:
    from classpro_tpu.tools.class2acc import main_run

    return main_run(args.estimate, args.truth, thres_e=args.max_e,
                    thres_r=args.min_r, thres_lq=args.show_lq,
                    show_class=args.show_class, min_r=args.lq_min_r,
                    max_r=args.lq_max_r, window=args.window,
                    prof_root=args.profile)


def cmd_gsthresholds(args: argparse.Namespace) -> int:
    from classpro_tpu.tools.classgs import genomescope_thresholds

    print(" ".join(str(t) for t in genomescope_thresholds(args.gs_dir)))
    return 0


def cmd_class2cns(args: argparse.Namespace) -> int:
    import sys

    from classpro_tpu.tools.class2cns import consistency, dump

    if args.consistency:
        print(f"Overall consistency = "
              f"{consistency(args.estimate, args.fastk_root)}")
    else:
        dump(args.estimate, args.fastk_root, sys.stdout)
    return 0


def cmd_show_seeds(args: argparse.Namespace) -> int:
    from classpro_tpu.tools.seedtracks import show_seeds

    show_seeds(args.fastk_root, args.db, sys.stdout)
    return 0


def cmd_repdepanno(args: argparse.Namespace) -> int:
    from classpro_tpu.tools.seedtracks import rep_dep_anno

    n = rep_dep_anno(args.fastk_root, args.db)
    print(f"{n} seed positions", file=sys.stderr)
    return 0


def cmd_simulate(args: argparse.Namespace) -> int:
    from classpro_tpu.tools.simulate import SimConfig, generate_dataset

    extra = {}
    if getattr(args, "repeat_rich", False):
        # ~15% of the genome in satellite arrays + two 10kb segdups
        n_arr = max(1, args.genome_len // 70_000)
        extra = dict(n_satellite_arrays=n_arr,
                     n_segdups=2 if args.genome_len > 25_000 else 0)
    cfg = SimConfig(seed=args.seed, genome_len=args.genome_len,
                    coverage=args.coverage, read_len_mean=args.read_len,
                    kmer=args.kmer, **extra)
    info = generate_dataset(args.outdir, cfg, nparts=args.nparts)
    print(info)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="classpro-tpu",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--platform", choices=["gpu", "cpu"],
                    help="JAX backend for the device programs.  Without "
                    "it JAX picks its default and the run stops if that "
                    "is not a GPU; 'cpu' runs the same programs on host "
                    "XLA (same output bytes)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("classify", help="classify every k-mer of every read")
    c.add_argument("source", help="reads (.fasta/.fastq[.gz])")
    c.add_argument("-N", "--fastk-root", help="FASTK output root (default: source root)")
    c.add_argument("-o", "--output", help="output .class path")
    c.add_argument("-c", "--coverage", type=int, default=0,
                   help="k-mer D-coverage override (-c in reference)")
    c.add_argument("-r", "--read-len", type=int, default=20000,
                   help="average read length (-r)")
    c.add_argument("-M", "--model", help="HIsim error model file (-M)")
    c.add_argument("-P", "--tmp-dir", default=".",
                   help="temp directory (-P in the reference; this "
                        "implementation streams output and creates no "
                        "temp files — accepted for CLI compatibility)")
    c.add_argument("-T", "--threads", type=int, default=4,
                   help="host-side worker count")
    c.add_argument("--engine", choices=["exact", "tpu"], default="tpu")
    c.add_argument("--pmm", action="store_true",
                   help="report per-read Poisson-mixture H/D coverage "
                        "estimates to stderr (ref DO_PMM, hist.c:159-310)")
    c.add_argument("-s", "--seeds", action="store_true",
                   help="also select alignment seeds (-s in reference); "
                        "writes <out>.seeds (per-position labels) and "
                        "<out>.rep (repeat intervals per read)")
    c.add_argument("-v", "--verbose", action="store_true")
    c.add_argument("--jax-profile", metavar="DIR",
                   help="write a JAX profiler (xprof) trace of the "
                        "classification stream to DIR (SURVEY §5 "
                        "observability; view with tensorboard or xprof)")
    c.add_argument("--devices", type=int, default=0, metavar="N",
                   help="round-robin chunks over the first N local "
                        "chips (replicated tables, zero cross-device "
                        "traffic; 0 = the default device only)")
    c.add_argument("--warmup", action="store_true",
                   help="pre-compile + first-execute the device program "
                        "for the dataset's expected shape bucket before "
                        "streaming")
    c.add_argument("--stats-json", metavar="PATH",
                   help="write run telemetry (wall, reads, k-mers, "
                        "platform, device kind, wall stage, guard flag "
                        "count + min margin, shape buckets, absorbed "
                        "chunks, compile time, DP loop steps) as JSON")
    c.add_argument("--server", metavar="SOCK",
                   help="delegate the job to a running `classpro-tpu "
                        "serve` daemon at this unix socket (its device "
                        "executables are already compiled; see serve.py)")
    c.set_defaults(fn=cmd_classify)

    sv = sub.add_parser(
        "serve", help="persistent warm-engine daemon: holds compiled "
                      "device executables across jobs; clients attach "
                      "with `classify --server SOCK`")
    sv.add_argument("--socket", required=True, metavar="SOCK",
                    help="unix socket path to listen on")
    sv.add_argument("--warmup-root", metavar="FASTK_ROOT",
                    help="pre-build device programs using this "
                         "dataset's model before taking traffic")
    sv.add_argument("--warmup-shape", action="append", default=[],
                    metavar="RxM", help="shape bucket(s) to warm, e.g. "
                                        "256x192 (repeatable)")
    sv.add_argument("-v", "--verbose", action="store_true")
    sv.set_defaults(fn=cmd_serve)

    g = sub.add_parser("classgs", help="global-threshold classification")
    g.add_argument("source")
    g.add_argument("eh", type=int, help="E/H count threshold")
    g.add_argument("hd", type=int, help="H/D count threshold")
    g.add_argument("dr", type=int, help="D/R count threshold")
    g.add_argument("-N", "--fastk-root")
    g.add_argument("-o", "--output")
    g.set_defaults(fn=cmd_classgs)

    p = sub.add_parser("prof2class", help="ground truth from relative profile")
    p.add_argument("truth_prof", help="relative profile root (FastK -p:<genome>)")
    p.add_argument("source", help="reads fastx")
    p.add_argument("-o", "--output")
    p.set_defaults(fn=cmd_prof2class)

    a = sub.add_parser("class2acc", help="accuracy vs truth .class")
    a.add_argument("estimate")
    a.add_argument("truth")
    a.add_argument("-f", "--max-e", type=int, default=100,
                   help="ignore reads with %%E-mer above this (ref -f)")
    a.add_argument("-r", "--min-r", type=int, default=0,
                   help="reads with %%R-mer above this are Repeat (ref -r)")
    a.add_argument("-e", "--show-lq", type=int, default=None,
                   help="report each read with misclassification rate "
                        ">= this %% (ref -e)")
    a.add_argument("-s", "--show-class", action="store_true",
                   help="with -e: print truth + masked estimate strings")
    a.add_argument("-m", "--lq-min-r", type=int, default=0,
                   help="with -e: min %%R-mer of a read to show (ref -m)")
    a.add_argument("-n", "--lq-max-r", type=int, default=100,
                   help="with -e: max %%R-mer of a read to show (ref -n)")
    a.add_argument("-w", "--window", type=int, default=None,
                   help="with -p: per-window accuracy/coverage (ref -w)")
    a.add_argument("-p", "--profile", default=None,
                   help="read profile root for coverage columns (ref -p)")
    a.set_defaults(fn=cmd_class2acc)

    gt = sub.add_parser("gs-thresholds",
                        help="E/H, H/D, D/R count thresholds from a "
                             "GenomeScope --fitted_hist output dir")
    gt.add_argument("gs_dir")
    gt.set_defaults(fn=cmd_gsthresholds)

    n = sub.add_parser("class2cns",
                       help="k-mer/class dump or consensus consistency")
    n.add_argument("estimate")
    n.add_argument("fastk_root")
    n.add_argument("-c", "--consistency", action="store_true",
                   help="print the harmonic-mean most-common-class "
                        "fraction instead of the dump")
    n.set_defaults(fn=cmd_class2cns)

    ss = sub.add_parser("show-seeds",
                        help="print seeds from a classified DB's track")
    ss.add_argument("fastk_root")
    ss.add_argument("db")
    ss.set_defaults(fn=cmd_show_seeds)

    rda = sub.add_parser("repdepanno",
                         help="emit .seed tracks from a classified DB")
    rda.add_argument("fastk_root")
    rda.add_argument("db")
    rda.set_defaults(fn=cmd_repdepanno)

    dr = sub.add_parser(
        "debug-read",
        help="single-read triage dump: oracle vs production internals "
             "(the reference's compile-time DEBUG_SINGLE, ClassPro.h:11-13, "
             "as a runtime command)")
    dr.add_argument("source", help="reads (.fasta/.fastq[.gz])")
    dr.add_argument("read_id", type=int)
    dr.add_argument("-N", "--fastk-root")
    dr.add_argument("-c", "--coverage", type=int, default=0)
    dr.add_argument("-r", "--read-len", type=int, default=20000)
    dr.add_argument("-M", "--model")
    dr.set_defaults(fn=cmd_debug_read)

    s = sub.add_parser("simulate", help="generate synthetic dataset")
    s.add_argument("outdir")
    s.add_argument("--seed", type=int, default=7)
    s.add_argument("--genome-len", type=int, default=100_000)
    s.add_argument("--coverage", type=float, default=40.0)
    s.add_argument("--read-len", type=int, default=10_000)
    s.add_argument("--kmer", type=int, default=40)
    s.add_argument("--nparts", type=int, default=1)
    s.add_argument("--repeat-rich", action="store_true",
                   help="adversarial repeat structure: alpha-satellite-"
                        "like tandem arrays (divergent 171bp monomers) "
                        "+ segmental duplications — centromere-grade R "
                        "tracts and max_m bucket pressure (VERDICT r4 "
                        "realism)")
    s.set_defaults(fn=cmd_simulate)
    return ap


def main(argv: list[str] | None = None) -> int:
    from classpro_tpu.backend import NoGpuError, select_platform

    args = build_parser().parse_args(argv)
    select_platform(args.platform)
    try:
        return args.fn(args)
    except (OSError, ValueError, struct.error, NoGpuError) as e:
        # bad/missing/corrupt input data: the reference prints one line
        # and exits 1 (gene_core Fopen / ClassPro.c rlen check); match
        # that instead of a traceback.  No GPU: same one-line exit.
        print(f"classpro-tpu: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
