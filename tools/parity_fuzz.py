#!/usr/bin/env python3
"""Randomized byte-identity fuzzer vs the reference binary (dev-time).

Each seed builds a crafted-count-profile batch (random step/ramp/noise
patterns with clustered error dips, random K in {16, 24, 32, 40}, random
H/D coverage peaks — the branch_probe generator), runs the reference
ClassPro and our production engine (CPU backend), and byte-compares the
.class outputs.  Any DIFFERS is a real divergence of the class that
found the XLA-division hdrr bug (COVERAGE.md).

Usage: python3 tools/parity_fuzz.py [n_seeds] [seed0]
"""

from __future__ import annotations

import filecmp
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from classpro_tpu.io.fastk import (histogram_from_counts, write_histogram,
                                   write_profiles)
from classpro_tpu.io.fastx import write_fasta

import tools.branch_probe as bp


# dataset generator used by build(); --extreme swaps in bp._extreme_batch
# (the discrete-underflow-directed generator, see its docstring)
_GEN = None
# --ndense: inject N runs into every read (see _inject_n)
_NDENSE = False


def _inject_n(rng, seq: str, counts, K: int):
    """Overwrite 1-6 random runs (1-2K bases) with 'N' and drop the
    counts of every covering k-mer window to 1 (error-level).

    NOT 0: profile entries of 0 SEGFAULT the reference binary
    (bisected 2026-08-20: N bases in the sequence alone are fine,
    counts[i]=0 crashes it) — 0-count profiles are outside the
    reference's supported input domain, so byte-parity fuzzing stays
    at >=1 while still driving the sequence-context scan through N
    runs.  Our own engine handles 0-count profiles cleanly (rc 0,
    verified on the bisect dataset) — a conscious robustness superset,
    recorded in PARITY.md."""
    b = bytearray(seq.encode())
    counts = np.asarray(counts, np.uint16).copy()
    plen = len(counts)
    for _ in range(int(rng.integers(1, 7))):
        L = int(rng.integers(1, 2 * K))
        p = int(rng.integers(0, max(1, len(b) - L)))
        b[p: p + L] = b"N" * min(L, len(b) - p)
        lo = max(0, p - K + 1)
        hi = min(plen, p + L)
        counts[lo:hi] = 1
    return b.decode(), counts


def build(seed: int, outdir: str, dam: bool = False,
          gen=None) -> tuple[int, str]:
    """Crafted dataset for one seed; returns (K, input file name).

    Container format (FASTA/FASTQ, plain/gzip) is drawn per seed so the
    native gzip-inflate + record-scan input path is fuzzed against the
    reference's kseq parsing, not only plain FASTA."""
    rng = np.random.default_rng(seed)
    K = int(rng.choice([16, 24, 32, 40]))
    bp.K = K  # the generator reads the module-level K for dip widths
    hist_counts, reads = (gen or _GEN or bp._random_batch)(seed)
    os.makedirs(outdir, exist_ok=True)
    profiles, recs = [], []
    for i, (counts, runs) in enumerate(reads):
        counts = np.asarray(counts, np.uint16)
        seq = bp._seq(rng, len(counts) + K - 1, runs)
        if _NDENSE:
            # N-dense mode: random N runs in the SEQUENCE with the
            # covering k-mer counts zeroed (FastK's convention for
            # non-ACGT k-mers) — fuzzes the sequence-context scan and
            # the 0-count walls against the reference's kseq+context
            seq, counts = _inject_n(rng, seq, counts, K)
        profiles.append(counts)
        recs.append((f"fuzz/{seed}/{i}", "", seq))
    root = os.path.join(outdir, "reads")
    if dam:
        from classpro_tpu.io.dazz import write_dam
        write_dam(root, [(h, s) for h, _, s in recs])
        fname = "reads.dam"
    else:
        import gzip as _gz

        fmt_rng = np.random.default_rng(seed ^ 0xF0F0)
        fname = "reads." + str(fmt_rng.choice(
            ["fasta", "fasta.gz", "fastq", "fastq.gz"]))
        if ".fastq" in fname:
            op = _gz.open if fname.endswith(".gz") else open
            with op(os.path.join(outdir, fname), "wt") as f:
                for name, comment, seq in recs:
                    hdr = f"@{name} {comment}" if comment else f"@{name}"
                    f.write(f"{hdr}\n{seq}\n+\n{'I' * len(seq)}\n")
        else:
            write_fasta(os.path.join(outdir, fname), recs)
    write_profiles(root, profiles, K)
    write_histogram(root, histogram_from_counts(K, hist_counts))
    return K, fname


def write_random_model(seed: int, path: str) -> int:
    """Random HIsim error-model file (load_himodel layout, wall.c:55-62:
    int32 kmer; 0x4000 heptamer E_Rates of 11 f4; per unit length 1..3,
    krange*4^ulen M_Rates of 7 f4).  Rates are resampled until the
    fitted quadratic keeps pe in (0,1) across l=1..lmax for every ctype
    (real HIsim models always do; out-of-range pe hits C's silent
    log(<=0)=nan, which is not a behavior worth byte-matching)."""
    import struct

    from classpro_tpu.constants import Defaults
    from classpro_tpu.estimation import _quadfit

    dflt = Defaults()
    x = np.arange(1.0, 6.0)
    for sub in range(64):
        rng = np.random.default_rng((seed << 8) | sub)
        kmer = int(rng.choice([32, 40]))
        krange = kmer // 2 - 6
        blocks, ok = [], True
        for t in range(3):
            ulen = t + 1
            n = 1 << (2 * ulen)
            # gently increasing mean rate with run length, unit scatter
            base = rng.uniform(0.002, 0.02)
            slope = rng.uniform(0.001, 0.01)
            m = np.zeros((n, krange, 7))
            for col in range(krange):
                j = (col + 2 * ulen) / ulen  # run length of this column
                mu = base + slope * j
                m[:, col, :] = rng.uniform(0.3 * mu, 1.7 * mu, (n, 7))
            m[rng.random(m.shape) < 0.08] = 0.0  # p>0 filter, wall.c:94
            # replicate the fit to pre-check the pe range
            y = np.zeros(5)
            y[0] = 0.002
            for j in range(2, 6):
                col = j * ulen - 2 * ulen
                v = m[:, col, 0]
                v = v[v > 0.0]
                y[j - 1] = v.mean() if len(v) else float("nan")
            c = _quadfit(x, y)
            lmax = dflt.max_n_lc // ulen
            ls = np.arange(1, lmax + 1)
            pe = c[0] + c[1] * ls + c[2] * ls * ls
            if not np.all((pe > 1e-9) & (pe < 0.9)):
                ok = False
                break
            blocks.append(m.astype("<f4"))
        if not ok:
            continue
        with open(path, "wb") as f:
            f.write(struct.pack("<i", kmer))
            f.write(rng.uniform(0, 0.3, 0x4000 * 11).astype("<f4")
                    .tobytes())
            for m in blocks:
                f.write(m.tobytes())
        return kmer
    raise RuntimeError(f"seed {seed}: no valid model in 64 tries")


def run_model_seed(seed: int, env: dict) -> str:
    """One -M fuzz seed: crafted dataset + random HIsim model, reference
    `ClassPro -M` vs `cli classify -M`, .class byte-compared."""
    d = f"/tmp/fuzzmod_{seed}"
    shutil.rmtree(d, ignore_errors=True)
    K, fname = build(seed, d)
    try:
        mk = write_random_model(seed, f"{d}/rand.model")
    except RuntimeError as e:   # no in-range model after 64 resamples
        shutil.rmtree(d, ignore_errors=True)
        return f"seed {seed}: SKIPPED ({e})"
    r = subprocess.run(["/tmp/refbuild/ClassPro", "-T1", f"-P{d}",
                        f"-M{d}/rand.model", fname], cwd=d,
                       capture_output=True, text=True)
    if r.returncode != 0:
        shutil.rmtree(d, ignore_errors=True)
        return (f"seed {seed} (K={K},mK={mk}): reference failed "
                f"({r.stderr.strip()[-120:]})")
    r2 = subprocess.run(
        [sys.executable, "-m", "classpro_tpu.cli", "classify",
         "-M", f"{d}/rand.model", f"{d}/{fname}",
         "-o", f"{d}/ours.class"],
        env=env, capture_output=True, text=True, timeout=600)
    if r2.returncode != 0:
        return (f"seed {seed} (K={K},mK={mk}): OURS CRASHED: "
                f"{r2.stderr.strip()[-300:]}")
    same = filecmp.cmp(f"{d}/reads.class", f"{d}/ours.class",
                       shallow=False)
    if same:
        shutil.rmtree(d, ignore_errors=True)
        return f"seed {seed} (K={K},mK={mk}): IDENTICAL"
    return f"seed {seed} (K={K},mK={mk}): *** DIFFERS ***"


# files produced by the DAZZ -s mode (ClassPro.c:289-304 track writers);
# all must be byte-identical between the reference run and ours
_DAM_OUTS = ("reads.class", ".reads.class.anno", ".reads.class.data",
             ".reads.rep.anno", ".reads.rep.data")


def run_dam_seed(seed: int, env: dict) -> str:
    """One -s/.dam fuzz seed: identical crafted dataset built twice
    (ref/ and ours/ so the hidden track files can't collide), reference
    `ClassPro -s` vs `cli classify -s`, all five outputs compared."""
    base = f"/tmp/fuzzdam_{seed}"
    shutil.rmtree(base, ignore_errors=True)
    K, _ = build(seed, f"{base}/ref", dam=True)
    build(seed, f"{base}/ours", dam=True)
    r = subprocess.run(["/tmp/refbuild/ClassPro", "-s", "-T1",
                        f"-P{base}/ref", "reads.dam"], cwd=f"{base}/ref",
                       capture_output=True, text=True)
    if r.returncode != 0:
        shutil.rmtree(base, ignore_errors=True)
        return (f"seed {seed} (K={K}): reference failed "
                f"({r.stderr.strip()[-120:]})")
    r2 = subprocess.run(
        [sys.executable, "-m", "classpro_tpu.cli", "classify", "-s",
         f"{base}/ours/reads.dam"],
        env=env, capture_output=True, text=True, timeout=600)
    if r2.returncode != 0:
        return (f"seed {seed} (K={K}): OURS CRASHED: "
                f"{r2.stderr.strip()[-300:]}")
    diffs = [f for f in _DAM_OUTS
             if not filecmp.cmp(f"{base}/ref/{f}", f"{base}/ours/{f}",
                                shallow=False)]
    if not diffs:
        shutil.rmtree(base, ignore_errors=True)
        return f"seed {seed} (K={K}): IDENTICAL (class + 4 tracks)"
    return f"seed {seed} (K={K}): *** DIFFERS *** {diffs}"


def _triage(seed: int, d: str, fname: str, env: dict) -> None:
    """Auto-triage a divergent seed: find the first read whose .class
    record differs and run `cli debug-read` on it (oracle + production
    internals side by side).  Both historical escapes (8339, 21517)
    needed exactly this dump, hand-written at the time."""
    from classpro_tpu.tools.debug_read import first_divergent_read

    rid = first_divergent_read(f"{d}/reads.class", f"{d}/ours.class")
    print(f"seed {seed}: first divergent read = {rid}; triage dump:",
          flush=True)
    if rid < 0:
        return
    r = subprocess.run(
        [sys.executable, "-m", "classpro_tpu.cli", "debug-read",
         f"{d}/{fname}", str(rid)],
        env=env, capture_output=True, text=True, timeout=600)
    print(r.stdout[-8000:], flush=True)
    if r.returncode not in (0, 2):
        print(f"(debug-read failed: {r.stderr[-500:]})", flush=True)
    print(f"(dataset kept at {d}; re-run: python3 -m classpro_tpu.cli "
          f"debug-read {d}/{fname} {rid})", flush=True)


def main() -> int:
    argv = [a for a in sys.argv[1:] if not a.startswith("--")]
    dam = "--dam" in sys.argv[1:]
    model = "--model" in sys.argv[1:]
    global _GEN, _NDENSE
    if "--extreme" in sys.argv[1:]:
        _GEN = bp._extreme_batch
    if "--cap" in sys.argv[1:]:
        _GEN = bp._cap_batch
    if "--ndense" in sys.argv[1:]:
        _NDENSE = True
    n = int(argv[0]) if len(argv) > 0 else 20
    seed0 = int(argv[1]) if len(argv) > 1 else 1000
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "1"
    if dam or model:
        run_one = run_model_seed if model else run_dam_seed
        bad = 0
        for seed in range(seed0, seed0 + n):
            msg = run_one(seed, env)
            print(msg, flush=True)
            if "DIFFERS" in msg or "CRASHED" in msg:
                bad += 1
        print(f"{bad} divergent/crashed of {n}")
        return 1 if bad else 0
    bad = 0
    for seed in range(seed0, seed0 + n):
        d = f"/tmp/fuzz_{seed}"
        shutil.rmtree(d, ignore_errors=True)
        K, fname = build(seed, d)
        r = subprocess.run(["/tmp/refbuild/ClassPro", "-T1", f"-P{d}",
                            fname], cwd=d, capture_output=True,
                           text=True)
        if r.returncode != 0:
            print(f"seed {seed} (K={K},{fname}): reference failed "
                  f"({r.stderr.strip()[-120:]})", flush=True)
            shutil.rmtree(d, ignore_errors=True)
            continue
        r2 = subprocess.run(
            [sys.executable, "-m", "classpro_tpu.cli", "classify",
             f"{d}/{fname}", "-o", f"{d}/ours.class"],
            env=env, capture_output=True, text=True, timeout=600)
        if r2.returncode != 0:
            print(f"seed {seed} (K={K},{fname}): OURS CRASHED: "
                  f"{r2.stderr.strip()[-300:]}", flush=True)
            bad += 1
            continue
        same = filecmp.cmp(f"{d}/reads.class", f"{d}/ours.class",
                           shallow=False)
        print(f"seed {seed} (K={K},{fname}): "
              + ("IDENTICAL" if same else "*** DIFFERS ***"), flush=True)
        if same:
            shutil.rmtree(d, ignore_errors=True)
        else:
            bad += 1
            _triage(seed, d, fname, env)
    print(f"{bad} divergent/crashed of {n}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
