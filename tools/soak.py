#!/usr/bin/env python3
"""Gbp-scale end-to-end soak of `cli classify` (VERDICT r3 #4).

Generates a ~0.5-1 Gbp synthetic HiFi dataset (same genome/read model
as classpro_tpu.tools.simulate, but with a VECTORIZED k-mer counter:
2-bit uint64 codes + np.unique, so K <= 32; the pure-Python counter in
simulate.py is ~1000x too slow at this scale), then:

1. runs `python -m classpro_tpu.cli classify` end-to-end as a child
   process, sampling VmRSS + output-file growth once a second
   (sustained-throughput curve, not just the final average);
2. spot-checks parity: N randomly sampled reads re-classified by the
   exact oracle and compared to the produced .class records;
3. exercises the scatter-gather path at scale: a 2-shard
   parallel/driver run (serial processes) + validated merge, byte-
   compared to the single run;
4. writes a JSON artifact (incl. --stats-json engine telemetry: guard
   flag count + min margin at soak scale).

Usage:
    python3 tools/soak.py [--gbp 0.5] [--platform gpu|cpu] [--out .smoke/soak.json]

Run on an idle machine (the CLAUDE.md measurement-hygiene rule).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from classpro_tpu.io.fastk import histogram_from_counts, write_histogram, write_profiles
from classpro_tpu.io.fastx import write_fasta
from classpro_tpu.tools.simulate import SimConfig, make_diploid, simulate_reads

K = 28  # <= 32 so a canonical k-mer packs into one uint64

_CODE = np.full(256, 255, np.uint8)
for i, b in enumerate(b"ACGT"):
    _CODE[b] = i
_COMP = np.array([3, 2, 1, 0], np.uint8)


def _kmer_codes(seq_u8: np.ndarray) -> np.ndarray:
    """Canonical 2-bit k-mer codes (uint64) for one read."""
    c = _CODE[seq_u8]
    n = len(c) - K + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    # forward rolling pack via cumulative shifts: windows of K 2-bit
    # symbols.  Build with a strided window over the code array.
    w = np.lib.stride_tricks.sliding_window_view(c, K).astype(np.uint64)
    shifts = (2 * (K - 1 - np.arange(K))).astype(np.uint64)
    fwd = (w << shifts).sum(axis=1, dtype=np.uint64)
    rc = _COMP[c][::-1]
    wr = np.lib.stride_tricks.sliding_window_view(rc, K).astype(np.uint64)
    rev_all = (wr << shifts).sum(axis=1, dtype=np.uint64)[::-1]
    return np.minimum(fwd, rev_all)


def generate(outdir: str, gbp: float, seed: int = 11,
             nparts: int = 2, kmer: int = 0, cov: float = 0.0) -> dict:
    os.makedirs(outdir, exist_ok=True)
    global K
    if kmer:
        assert kmer <= 32, "vectorized counter packs K<=32 in uint64"
        K = kmer
    # default: keep coverage >= ~40x so estimation sees real peaks; cap
    # the genome at 6 Mbp so the 0.5-1 Gbp soak runs ~80-170x
    # (HiFi-like).  --cov pins the coverage instead (extra geometries
    # for matched baselines, VERDICT r4 #3).
    if cov:
        genome_len = int(gbp * 1e9 / cov)
    else:
        genome_len = min(6_000_000, int(gbp * 1e9 / 40))
    coverage = gbp * 1e9 / genome_len
    cfg = SimConfig(seed=seed, genome_len=genome_len, coverage=coverage,
                    read_len_mean=12_000, read_len_sd=2_500,
                    read_len_min=4_000, kmer=K)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    haps = make_diploid(cfg, rng)
    reads = simulate_reads(cfg, rng, haps)
    n_bases = sum(len(r[2]) for r in reads)
    print(f"[gen] {len(reads)} reads, {n_bases/1e9:.3f} Gbp "
          f"({time.time()-t0:.0f}s)", flush=True)

    codes = [None] * len(reads)
    for i, (_, _, s) in enumerate(reads):
        codes[i] = _kmer_codes(np.frombuffer(s.encode(), np.uint8))
        if i % 20000 == 0:
            print(f"[gen] kmer codes {i}/{len(reads)}", flush=True)
    allc = np.concatenate(codes)
    print(f"[gen] {len(allc)/1e6:.0f}M kmer instances, sorting...",
          flush=True)
    uniq, counts = np.unique(allc, return_counts=True)
    counts16 = np.minimum(counts, 32767).astype(np.uint16)
    del allc
    print(f"[gen] {len(uniq)/1e6:.1f}M distinct ({time.time()-t0:.0f}s)",
          flush=True)

    profiles = [counts16[np.searchsorted(uniq, c)] for c in codes]
    del codes
    root = os.path.join(outdir, "reads")
    write_fasta(root + ".fasta", reads)
    write_profiles(root, profiles, K, nparts=nparts)
    write_histogram(root, histogram_from_counts(K, counts))
    meta = {"n_reads": len(reads), "n_bases": n_bases,
            "n_kmers": int(sum(len(p) for p in profiles)),
            "n_distinct": int(len(uniq)), "kmer": K, "nparts": nparts,
            "gen_seconds": round(time.time() - t0, 1)}
    with open(os.path.join(outdir, "meta.json"), "w") as f:
        json.dump(meta, f)
    print(f"[gen] done {meta}", flush=True)
    return meta


def _rss_kb(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def run_classify(d: str, platform: str) -> dict:
    env = dict(os.environ)
    out = os.path.join(d, "soak.class")
    stats_path = os.path.join(d, "soak.stats.json")
    # a stale out file from a previous run sits at full size until the
    # CLI truncates it post-warmup, corrupting the growth/stall samples
    for p in (out, stats_path):
        if os.path.exists(p):
            os.remove(p)
    cmd = [sys.executable, "-m", "classpro_tpu.cli", "--platform", platform]
    # --warmup: one dataset-aware build up front (engine samples the
    # wall stage over the first chunk and warms exactly the dataset's
    # bucket); absorption covers every other chunk shape, so the fresh
    # process compiles ONCE (VERDICT r4 #2).
    cmd += ["classify", "-v", "--warmup", "--stats-json", stats_path,
            os.path.join(d, "reads.fasta"), "-o", out]
    t0 = time.time()
    p = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                         stderr=subprocess.PIPE, text=True)
    samples = []
    while p.poll() is None:
        time.sleep(1.0)
        sz = os.path.getsize(out) if os.path.exists(out) else 0
        samples.append({"t": round(time.time() - t0, 1),
                        "rss_mb": round(_rss_kb(p.pid) / 1024, 1),
                        "out_mb": round(sz / 1e6, 1)})
        if len(samples) % 30 == 0:
            print(f"[classify] t={samples[-1]['t']}s "
                  f"rss={samples[-1]['rss_mb']}MB "
                  f"out={samples[-1]['out_mb']}MB", flush=True)
    err = p.communicate()[1]
    wall = time.time() - t0
    assert p.returncode == 0, err[-2000:]
    # Sustained throughput = output growth during GROWTH seconds only.
    # A fresh process compiles one device program per shape bucket,
    # which shows as flat stretches in the curve; the sustained number
    # is the slope while the stream actually flows.
    grow_s = 0.0
    grow_mb = 0.0
    stall_s = 0.0
    for a, b in zip(samples, samples[1:]):
        d = b["out_mb"] - a["out_mb"]
        if d > 0:
            grow_s += b["t"] - a["t"]
            grow_mb += d
        else:
            stall_s += b["t"] - a["t"]
    sus = grow_mb / grow_s if grow_s else None
    eng_stats = {}
    try:
        with open(stats_path) as f:
            eng_stats = json.load(f)
    except (OSError, ValueError):
        pass
    return {"wall_s": round(wall, 1),
            # exactness-guard telemetry at soak scale (VERDICT r4 #5):
            # flag count and worst margin ride the artifact so a margin
            # collapse at scale is visible, not just in bench runs
            "engine_stats": eng_stats,
            "rss_peak_mb": max((s["rss_mb"] for s in samples), default=-1),
            "sustained_out_mb_s": round(sus, 2) if sus else None,
            "growth_seconds": round(grow_s, 1),
            "stall_seconds": round(stall_s, 1),
            "samples": samples[:: max(1, len(samples) // 120)],
            "stderr_tail": err.strip().splitlines()[-3:]}


def run_classify_served(d: str, platform: str) -> dict:
    """The amortization framing (VERDICT r4 #2): a `cli serve` daemon
    warms the dataset's shape buckets ONCE, then a `classify --server`
    job attaches.  Reported separately from the fresh-process framing:
    the daemon compiles at startup; the JOB should stream essentially
    stall-free."""
    env = dict(os.environ)
    cmd0 = [sys.executable, "-m", "classpro_tpu.cli", "--platform", platform]
    sock = os.path.join(d, "cp.sock")
    out = os.path.join(d, "served.class")
    t0 = time.time()
    srv = subprocess.Popen(
        cmd0 + ["serve", "--socket", sock, "-v",
                "--warmup-root", os.path.join(d, "reads"),
                "--warmup-shape", "256x192", "--warmup-shape", "256x256"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    from classpro_tpu.serve import request

    warm = None
    deadline = time.time() + 1800
    while time.time() < deadline:
        if srv.poll() is not None:
            raise AssertionError(
                f"serve died: {srv.stderr.read()[-2000:]}")
        if os.path.exists(sock):
            try:
                if request(sock, {"cmd": "ping"}, timeout=5)["ok"]:
                    warm = round(time.time() - t0, 1)
                    break
            except (ConnectionError, OSError):
                pass
        time.sleep(1.0)
    assert warm is not None, "serve never became ready"
    t1 = time.time()
    cli = subprocess.Popen(
        cmd0 + ["classify", "--server", sock,
                os.path.join(d, "reads.fasta"), "-o", out],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    samples = []
    while cli.poll() is None:
        time.sleep(1.0)
        sz = os.path.getsize(out) if os.path.exists(out) else 0
        samples.append({"t": round(time.time() - t1, 1),
                        "out_mb": round(sz / 1e6, 1)})
    err = cli.communicate()[1]
    wall = time.time() - t1
    assert cli.returncode == 0, err[-2000:]
    grow_s = stall_s = grow_mb = 0.0
    for a, b in zip(samples, samples[1:]):
        dd = b["out_mb"] - a["out_mb"]
        if dd > 0:
            grow_s += b["t"] - a["t"]
            grow_mb += dd
        else:
            stall_s += b["t"] - a["t"]
    try:
        request(sock, {"cmd": "shutdown"}, timeout=10)
        srv.wait(timeout=60)
    except Exception:
        srv.kill()
    same = _files_equal(out, os.path.join(d, "soak.class"))
    return {"server_warmup_s": warm, "job_wall_s": round(wall, 1),
            "stall_seconds": round(stall_s, 1),
            "growth_seconds": round(grow_s, 1),
            "sustained_out_mb_s": round(grow_mb / grow_s, 2)
            if grow_s else None,
            "equal_to_fresh": same,
            "samples": samples[:: max(1, len(samples) // 60)]}


def spot_parity(d: str, n: int, meta: dict, seed: int = 5) -> dict:
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.exact.pipeline import ReadClassifier
    from classpro_tpu.io.fastk import load_histogram, open_profiles

    root = os.path.join(d, "reads")
    gm = build_global_model(load_histogram(root))
    P = open_profiles(root)
    rng = np.random.default_rng(seed)
    picks = sorted(rng.choice(meta["n_reads"], size=n, replace=False))
    clf = ReadClassifier(gm)
    # stream the .class file once, grabbing the sampled records
    want = {}
    with open(os.path.join(d, "soak.class")) as f:
        rid = 0
        pi = 0
        while pi < len(picks):
            rec = [f.readline() for _ in range(4)]
            if not rec[0]:
                break
            if rid == picks[pi]:
                want[rid] = (rec[1].rstrip("\n"), rec[3].rstrip("\n"))
                pi += 1
            rid += 1
    mism = 0
    for rid in picks:
        seq, got = want[rid]
        exp = clf.classify(seq, P.fetch(int(rid)))
        if exp != got:
            mism += 1
            print(f"[parity] read {rid} MISMATCH", flush=True)
    return {"sampled": len(picks), "mismatches": mism}


def shard_merge(d: str, platform: str) -> dict:
    """2-shard parallel/driver run (serial CHILD processes — each with
    a clean jax init, as in real multi-host use) + validated merge."""
    from classpro_tpu.io.fastk import open_profiles
    from classpro_tpu.parallel.driver import merge_shards, shard_range

    env = dict(os.environ)
    if platform == "cpu":       # the driver has no --platform flag
        env["JAX_PLATFORMS"] = "cpu"
    root = os.path.join(d, "reads")
    out = os.path.join(d, "sharded.class")
    t0 = time.time()
    for pid in range(2):
        r = subprocess.run(
            [sys.executable, "-c",
             "from classpro_tpu.parallel.driver import run_process; "
             f"run_process({(root + '.fasta')!r}, {root!r}, {out!r}, "
             f"nproc=2, pid={pid}, _skip_init=True)"],
            env=env, capture_output=True, text=True, timeout=7200)
        assert r.returncode == 0, r.stderr[-2000:]
    nreads = open_profiles(root).nreads
    expected = [e - b for b, e in (shard_range(nreads, 2, p)
                                   for p in range(2))]
    merge_shards(out, 2, expected)
    same = _files_equal(out, os.path.join(d, "soak.class"))
    return {"wall_s": round(time.time() - t0, 1), "merge_equal": same}


def _files_equal(a: str, b: str) -> bool:
    import filecmp

    return filecmp.cmp(a, b, shallow=False)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbp", type=float, default=0.5)
    ap.add_argument("--kmer", type=int, default=0,
                    help="k-mer size for generation (<=32; default 28)")
    ap.add_argument("--cov", type=float, default=0.0,
                    help="pin the dataset coverage (default: 6Mb genome cap)")
    ap.add_argument("--dir", default=os.path.join(REPO, ".smoke", "soak"))
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    ap.add_argument("--out", default=os.path.join(REPO, ".smoke",
                                                  "soak.json"))
    ap.add_argument("--spot", type=int, default=420,
                help="sampled exact-oracle parity reads (>=1% of the 0.5 Gbp dataset, VERDICT r4 #5)")
    ap.add_argument("--skip-gen", action="store_true")
    ap.add_argument("--skip-shard", action="store_true")
    ap.add_argument("--skip-serve", action="store_true")
    a = ap.parse_args()

    d = a.dir
    if a.skip_gen and os.path.exists(os.path.join(d, "meta.json")):
        meta = json.load(open(os.path.join(d, "meta.json")))
    else:
        meta = generate(d, a.gbp, kmer=a.kmer, cov=a.cov)
    res = {"meta": meta, "platform": a.platform,
           "ts": time.strftime("%Y-%m-%d %H:%M:%S")}
    res["classify"] = run_classify(d, a.platform)
    kmers = meta["n_kmers"]
    res["classify"]["mkmers_per_s_e2e"] = round(
        kmers / res["classify"]["wall_s"] / 1e6, 2)
    print(f"[classify] wall={res['classify']['wall_s']}s "
          f"e2e={res['classify']['mkmers_per_s_e2e']} Mk/s "
          f"rss_peak={res['classify']['rss_peak_mb']}MB", flush=True)
    if not a.skip_serve:
        res["served"] = run_classify_served(d, a.platform)
        res["served"]["mkmers_per_s_job"] = round(
            kmers / res["served"]["job_wall_s"] / 1e6, 2)
        print(f"[served] warmup={res['served']['server_warmup_s']}s "
              f"job={res['served']['job_wall_s']}s "
              f"({res['served']['mkmers_per_s_job']} Mk/s, stalls "
              f"{res['served']['stall_seconds']}s)", flush=True)
    res["spot_parity"] = spot_parity(d, a.spot, meta)
    print(f"[parity] {res['spot_parity']}", flush=True)
    if not a.skip_shard:
        res["shard_merge"] = shard_merge(d, a.platform)
        print(f"[shard] {res['shard_merge']}", flush=True)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {a.out}", flush=True)
    ok = (res["spot_parity"]["mismatches"] == 0
          and (a.skip_shard or res["shard_merge"]["merge_equal"])
          and (a.skip_serve or res["served"]["equal_to_fresh"]))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
