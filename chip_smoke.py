#!/usr/bin/env python3
"""Smoke run of the classify path on the GPU, through its entry points.

Every phase drives what a user calls -- ``python -m classpro_tpu.cli
--platform gpu classify|serve``, ``classify --server`` and the shard
driver -- and checks each output byte against the reference goldens
(tests/fixtures) or the exact oracle (classpro_tpu/exact).  The run
exits non-zero if any phase fails, and prints its one-line JSON result
last only when all passed.

This process never initialises JAX: whatever needs the card runs in a
child process, one at a time (the serve phase's clients do not touch
JAX), so the card only ever holds one JAX process.  Children use the
compile cache as found (JAX_COMPILATION_CACHE_DIR, else the program's
.jax_cache/), except the scale phase's timed runs: they use
.smoke/jax_cache_cold, emptied first, so that its first compile is cold
and the next process's is warm.

Usage:
    python chip_smoke.py                # one card: golden, scale, served, div_cr
    python chip_smoke.py --four-cards   # four cards: round-robin, shard
                                        # driver, mesh dryrun -- nothing else

Work files go to .smoke/ in the checkout (listed in .gitignore); the
scale dataset is cached there, keyed by its parameters.
"""

from __future__ import annotations

import argparse
import filecmp
import gzip
import hashlib
import json
import os
import select
import shutil
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")
FIX = os.path.join(REPO, "tests", "fixtures")

COLD_CACHE = os.path.join(WORK, "jax_cache_cold")

ONE_CARD_PHASES = ("golden", "scale", "served", "div_cr")
FOUR_CARD_PHASES = ("round_robin4", "shard_driver4", "mesh4")

# scale dataset: diploid HiFi-like reads, 0.1 Gbp over a 2.5 Mbp genome
# (40x), 12 kbp mean read length, K=28 (tools/soak.py's vectorised
# counter packs K <= 32); ~8.3k reads, ~100 M k-mers, ~42 chunks of 200
SCALE = {"gbp": 0.1, "cov": 40.0, "kmer": 28, "seed": 11}
ORACLE_SAMPLE = 128
DIV_PAIRS = 1 << 20
PLATFORM = "gpu"


class PhaseError(Exception):
    pass


def select_phases(four_cards: bool) -> tuple[str, ...]:
    """The phases a run executes after the device check."""
    return FOUR_CARD_PHASES if four_cards else ONE_CARD_PHASES


def result_line(device: dict) -> str:
    """The last line of a successful run."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------
# child processes
# ---------------------------------------------------------------------

def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env.pop("JAX_PLATFORMS", None)        # --platform gpu decides
    return env


def cold_cache_env() -> dict:
    """Child env whose compile cache is COLD_CACHE, whatever cache the
    caller set: a cache from outside may already hold these programs,
    and then a compile timed there is not cold."""
    env = child_env()
    env["JAX_COMPILATION_CACHE_DIR"] = COLD_CACHE
    return env


def run(cmd: list[str], timeout: float, env: dict | None = None,
        what: str = "") -> subprocess.CompletedProcess:
    t0 = time.time()
    try:
        r = subprocess.run(cmd, cwd=REPO, env=env or child_env(),
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        raise PhaseError(f"{what or cmd[:4]} timed out after {timeout}s")
    r.wall_s = time.time() - t0
    if r.returncode != 0:
        raise PhaseError(f"{what or cmd[:4]} exited {r.returncode}: "
                         f"{r.stderr[-3000:]}")
    return r


def cli(*args: str, timeout: float = 600, what: str = "",
        env: dict | None = None):
    return run([sys.executable, "-m", "classpro_tpu.cli", "--platform",
                PLATFORM, *args], timeout, env=env,
               what=what or " ".join(args[:2]))


def worker(call: str, timeout: float = 600, env: dict | None = None) -> dict:
    """Run ``chip_smoke.<call>`` in a child; it prints one JSON line."""
    r = run([sys.executable, "-c", f"import chip_smoke as s; s.{call}"],
            timeout, env=env, what=call.split("(")[0])
    return json.loads(r.stdout.strip().splitlines()[-1])


def _gpu_jax():
    from classpro_tpu.backend import require_gpu, select_platform

    select_platform(PLATFORM)
    require_gpu()
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def probe() -> None:
    """Child: the device as JAX sees it, and the host library."""
    import importlib.metadata as md

    jax = _gpu_jax()
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram
    from classpro_tpu.tpu.engine import make_wall_stage

    devs = jax.devices()
    gm = build_global_model(load_histogram(os.path.join(FIX, "tiny",
                                                        "reads")))
    wall = make_wall_stage(gm)
    plugins = {d.metadata["Name"]: d.version for d in md.distributions()
               if d.metadata["Name"].startswith("jax-cuda")
               or d.metadata["Name"].startswith("jax_cuda")}
    print(json.dumps({
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs), "jax": jax.__version__,
        "backend_version": getattr(devs[0].client, "platform_version",
                                   None),
        "cuda_plugins": plugins,
        "wall_stage": "native" if type(wall).__name__ == "NativeWall"
        else "python"}))


def div_check(n: int = DIV_PAIRS) -> None:
    """Child: _div_cr and plain '/' on the card vs numpy's IEEE quotient,
    and _two_prod's exactness, all inside one jitted (fused) program."""
    jax = _gpu_jax()
    import fractions

    import jax.numpy as jnp
    import numpy as np

    from classpro_tpu.tpu.rel_dev2 import _div_cr, _two_prod

    rng = np.random.default_rng(5)
    # the unit test's cases (int-valued dh-ratio operands, x/x, reals)
    a0 = np.concatenate([rng.integers(1, 60000, 400).astype(np.float64),
                         np.array([71.0 / 27.0, 1e3, 3.0, 7.0]),
                         rng.uniform(1e-3, 1e6, 400)])
    b0 = np.concatenate([rng.integers(1, 60000, 400).astype(np.float64),
                         np.array([71.0 / 27.0, 1e3, 3.0, 7.0]),
                         rng.uniform(1e-3, 1e6, 400)])
    q = n // 4
    a = np.concatenate([
        a0, rng.integers(1, 1 << 40, q).astype(np.float64),
        rng.uniform(1e-3, 1e6, q),
        np.exp(rng.uniform(-300, 300, q)), rng.standard_normal(q)])
    b = np.concatenate([
        b0, rng.integers(1, 1 << 17, q).astype(np.float64),
        rng.uniform(1e-3, 1e6, q),
        np.exp(rng.uniform(-300, 300, q)), rng.standard_normal(q)])
    b[b == 0] = 1.0
    want = a / b

    f = jax.jit(lambda x, y: (_div_cr(x, y), x / y) + _two_prod(x, y))
    dc, dp, hi, lo = (np.asarray(v) for v in f(jnp.asarray(a),
                                               jnp.asarray(b)))
    case = slice(0, len(a0))
    sample = rng.choice(len(a), 20000, replace=False)
    F = fractions.Fraction
    # Dekker's split is exact away from overflow and underflow
    sample = [i for i in sample if 1e-150 < abs(a[i]) < 1e150
              and 1e-150 < abs(b[i]) < 1e150 and abs(a[i] * b[i]) > 1e-280]
    tp_bad = sum(1 for i in sample
                 if F(float(hi[i])) + F(float(lo[i]))
                 != F(float(a[i])) * F(float(b[i])))
    print(json.dumps({
        "pairs": int(len(a)),
        "div_cr_mismatch": int((dc != want).sum()),
        "div_cr_case_mismatch": int((dc[case] != want[case]).sum()),
        "div_cr_x_over_x": float(np.asarray(
            jax.jit(_div_cr)(jnp.asarray(71.0 / 27.0),
                             jnp.asarray(71.0 / 27.0)))),
        "plain_div_mismatch": int((dp != want).sum()),
        "two_prod_checked": int(len(sample)),
        "two_prod_inexact": int(tp_bad)}))


def device_timing(root: str, n_chunks: int = 8, batch: int = 200) -> None:
    """Child: warm per-chunk time of the rel device program alone on
    real chunks (upload excluded, ends in block_until_ready), its DP
    loop steps, and the steady stream rate over the whole dataset with
    inputs pre-decoded."""
    jax = _gpu_jax()
    import numpy as np

    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import TpuEngine

    gm = build_global_model(load_histogram(root))
    P = open_profiles(root)
    seqs = [r.seq for r in read_fastx(root + ".fasta")]
    profs = [P.fetch(i) for i in range(len(seqs))]
    eng = TpuEngine(gm, batch_size=batch)
    chunks = [(seqs[i:i + batch], profs[i:i + batch])
              for i in range(0, len(seqs), batch)]
    per = []
    for s, p in chunks[:n_chunks]:
        st = eng._stage(s, p)
        fb, ib = eng._pack_st(st, st["_R"], st["_mm"])
        ex = eng._rel_exec(st["_R"], st["_mm"])
        fb, ib = jax.device_put(fb), jax.device_put(ib)
        ex(fb, ib).block_until_ready()            # first execution
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            ex(fb, ib).block_until_ready()
            reps.append(time.perf_counter() - t0)
        per.append({"shape": [st["_R"], st["_mm"]],
                    "dp_steps": int(st["n_rel"].max()) - 1,
                    "device_ms": 1e3 * sorted(reps)[1]})
        eng.wall.release_slab(st["slab"])
    kmers = sum(len(p) for p in profs)
    for _ in eng.classify_stream(iter(chunks), sort_window=8):  # settle:
        pass                                      # every shape compiled
    compile_s = eng.compile_s
    t0 = time.perf_counter()
    for _ in eng.classify_stream(iter(chunks), sort_window=8):
        pass
    steady = time.perf_counter() - t0
    print(json.dumps({
        "chunks_timed": per, "compile_s": compile_s,
        "compile_s_in_window": eng.compile_s - compile_s,
        "device_ms_mean": sum(c["device_ms"] for c in per) / len(per),
        "dp_steps_mean": sum(c["dp_steps"] for c in per) / len(per),
        "steady_s": steady, "kmers": kmers,
        "steady_mkmers_s": kmers / steady / 1e6}))


# ---------------------------------------------------------------------
# phases (parent side)
# ---------------------------------------------------------------------

def _gunzip(src: str, dst: str) -> str:
    with gzip.open(src, "rb") as f, open(dst, "wb") as g:
        shutil.copyfileobj(f, g)
    return dst


def _same(a: str, b: str) -> bool:
    return filecmp.cmp(a, b, shallow=False)


def _stats(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _golden_case(name: str, fx: str, golden: str, extra=()) -> dict:
    out = os.path.join(WORK, "out", name + ".class")
    sj = out + ".stats.json"
    r = cli("classify", os.path.join(fx, "reads.fasta.gz"), "-N",
            os.path.join(fx, "reads"), "-o", out, "--stats-json", sj,
            *extra, what=f"classify {name}")
    want = _gunzip(golden, os.path.join(WORK, "gold", name + ".class"))
    st = _stats(sj)
    st["process_s"] = r.wall_s
    st["identical"] = _same(out, want)
    log(f"[golden] {name}: identical={st['identical']} "
        f"guard_flagged={st['guard_flagged']} "
        f"min_margin={st['min_margin']} process_s={r.wall_s} "
        f"first_chunk_s={st['first_chunk_s']} compile_s={st['compile_s']}")
    return st


def phase_golden() -> dict:
    res = {}
    tiny, medium = os.path.join(FIX, "tiny"), os.path.join(FIX, "medium")
    res["tiny"] = _golden_case("tiny", tiny,
                               os.path.join(tiny, "golden.class.gz"))
    res["tiny_s"] = _golden_case("tiny_s", tiny,
                                 os.path.join(tiny, "golden.class.gz"),
                                 extra=("-s",))
    res["tiny_s"]["seeds_identical"] = _seeds_match(
        os.path.join(WORK, "out", "tiny_s.class.seeds"),
        os.path.join(tiny, "golden.seeds.gz"))
    log(f"[golden] tiny -s seeds identical="
        f"{res['tiny_s']['seeds_identical']}")
    res["medium"] = _golden_case("medium", medium,
                                 os.path.join(medium, "golden.class.gz"))
    model = _gunzip(os.path.join(tiny, "hisim.model.gz"),
                    os.path.join(WORK, "gold", "hisim.model"))
    res["tiny_M"] = _golden_case("tiny_M", tiny,
                                 os.path.join(tiny, "golden_M.class.gz"),
                                 extra=("-M", model))
    res["branch"] = worker("golden_branch()", timeout=900)
    for name, st in res["branch"].items():
        log(f"[golden] branch/{name}: identical={st['identical']} "
            f"guard_flagged={st['guard_flagged']} "
            f"min_margin={st['min_margin']}")
    bad = [k for k, v in res.items() if k != "branch" and
           not (v["identical"] and v.get("seeds_identical", True))]
    bad += [f"branch/{k}" for k, v in res["branch"].items()
            if not v["identical"]]
    if bad:
        raise PhaseError(f"output differs from the golden: {bad}")
    return res


def _seeds_match(seeds_path: str, golden: str) -> bool:
    """The -s labels of every read equal the reference seed.c harness's
    labels (the CLI writes header + N*(K-1) + labels per read)."""
    from classpro_tpu.io.fastk import open_profiles

    K = open_profiles(os.path.join(FIX, "tiny", "reads")).kmer
    with gzip.open(golden, "rt") as f:
        gold = f.read().splitlines()
    with open(seeds_path) as f:
        ours = f.read().splitlines()[1::2]
    return len(ours) == len(gold) and all(
        o == "N" * (K - 1) + g for o, g in zip(ours, gold))


def golden_branch() -> None:
    """Child: every tests/fixtures/branch case through cli.main in one
    process, with its args.json as the branch parity test uses them."""
    from classpro_tpu.cli import main

    res = {}
    base = os.path.join(FIX, "branch")
    for name in sorted(os.listdir(base)):
        fx = os.path.join(base, name)
        args = {}
        if os.path.exists(os.path.join(fx, "args.json")):
            with open(os.path.join(fx, "args.json")) as f:
                args = json.load(f)
        out = os.path.join(WORK, "out", f"branch_{name}.class")
        flags = []
        if "coverage" in args:
            flags += ["-c", str(args["coverage"])]
        if "read_len" in args:
            flags += ["-r", str(args["read_len"])]
        if main(["--platform", PLATFORM, "classify",
                 os.path.join(fx, "reads.fasta.gz"), "-N",
                 os.path.join(fx, "reads"), "-o", out, "--stats-json",
                 out + ".stats.json", *flags]) != 0:
            raise SystemExit(f"classify branch/{name} failed")
        want = _gunzip(os.path.join(fx, "golden.class.gz"),
                       os.path.join(WORK, "gold", f"branch_{name}.class"))
        st = _stats(out + ".stats.json")
        res[name] = {"identical": _same(out, want),
                     "guard_flagged": st["guard_flagged"],
                     "min_margin": st["min_margin"]}
    print(json.dumps(res))


def scale_dataset() -> tuple[str, dict]:
    """Generate (or reuse) the seeded scale dataset; no JAX here."""
    key = "g{gbp}_c{cov}_k{kmer}_s{seed}".format(**SCALE)
    d = os.path.join(WORK, "data", key)
    meta_path = os.path.join(d, "meta.json")
    if not os.path.exists(meta_path):
        sys.path.insert(0, os.path.join(REPO, "tools"))
        import soak

        t0 = time.time()
        shutil.rmtree(d, ignore_errors=True)
        soak.generate(d + ".part", SCALE["gbp"], seed=SCALE["seed"],
                      kmer=SCALE["kmer"], cov=SCALE["cov"])
        os.replace(d + ".part", d)
        log(f"[scale] generated {key} in {time.time() - t0:.1f}s")
    with open(meta_path) as f:
        return os.path.join(d, "reads"), json.load(f)


def _check_records(out: str, root: str, meta: dict) -> list:
    """Record count, headers and sequences of a .class file against the
    input FASTA; returns (seq, classes) per read."""
    from classpro_tpu.io.classfile import class_header
    from classpro_tpu.io.fastx import read_fastx

    recs = []
    with open(out) as f:
        lines = f.read().split("\n")
    if lines[-1] != "" or (len(lines) - 1) % 4:
        raise PhaseError(f"{out}: not a whole number of 4-line records")
    for i, r in enumerate(read_fastx(root + ".fasta")):
        h, s, plus, c = lines[4 * i: 4 * i + 4]
        if (h != class_header(r.name, r.comment) or s != r.seq
                or plus != "+" or len(c) != len(s)):
            raise PhaseError(f"{out}: record {i} header/sequence/length "
                             f"does not match the input")
        recs.append((s, c))
    if len(recs) != meta["n_reads"] or 4 * len(recs) != len(lines) - 1:
        raise PhaseError(f"{out}: {(len(lines) - 1) // 4} records, "
                         f"expected {meta['n_reads']}")
    return recs


def phase_scale() -> dict:
    import numpy as np

    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.exact.pipeline import ReadClassifier
    from classpro_tpu.io.fastk import load_histogram, open_profiles

    root, meta = scale_dataset()
    # the same classify twice in one emptied cache: cold, then warm
    shutil.rmtree(COLD_CACHE, ignore_errors=True)
    env = cold_cache_env()
    runs = {}
    for temp in ("cold", "warm"):
        o = os.path.join(WORK, "out", f"scale_{temp}.class")
        r = cli("classify", root + ".fasta", "-o", o, "--stats-json",
                o + ".stats.json", timeout=900, env=env,
                what=f"classify scale ({temp} compile cache)")
        runs[temp] = {"out": o, "process_s": r.wall_s,
                      "stats": _stats(o + ".stats.json")}
    out, st = runs["cold"]["out"], runs["warm"]["stats"]
    if not _same(out, runs["warm"]["out"]):
        raise PhaseError("the warm run's output differs from the cold run's")
    recs = _check_records(out, root, meta)
    gm = build_global_model(load_histogram(root))
    P = open_profiles(root)
    oracle = ReadClassifier(gm)
    picks = np.random.default_rng(SCALE["seed"]).choice(
        len(recs), ORACLE_SAMPLE, replace=False)
    bad = [int(i) for i in picks
           if oracle.classify(recs[i][0], P.fetch(int(i))) != recs[i][1]]
    dev = worker(f"device_timing({root!r})", timeout=900, env=env)
    with open(out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    for temp, one in runs.items():
        rs = one["stats"]
        one["e2e_mkmers_s"] = meta["n_kmers"] / one["process_s"] / 1e6
        log(f"[scale] compile cache {temp}: process wall "
            f"{one['process_s']:.2f}s = {one['e2e_mkmers_s']:.2f} Mk-mers/s"
            f" end to end; first_chunk_s {rs['first_chunk_s']:.2f}; "
            f"compile_s {rs['compile_s']:.2f}; stream {rs['stream_wall_s']}s"
            f" = {meta['n_kmers'] / rs['stream_wall_s'] / 1e6:.2f} Mk-mers/s")
    res = {"meta": meta, "runs": runs, "sha256": digest,
           "oracle_sampled": len(picks), "oracle_mismatch": bad,
           "device": dev}
    log(f"[scale] {meta['n_reads']} reads, {meta['n_kmers']} k-mers; "
        f"steady {dev['steady_mkmers_s']:.2f} Mk-mers/s (second pass, "
        f"compile in window {dev['compile_s_in_window']:.2f}s; compile "
        f"{dev['compile_s']:.2f}s in that process, cache warm); chunks "
        f"{st['chunks']} absorbed {st['absorbed_chunks']} shapes "
        f"{st['shapes']}; output sha256 {digest}")
    log(f"[scale] DP steps/chunk {st['dp_steps'] / max(st['chunks'], 1):.1f}"
        f" (stream), timed chunks: {dev['dp_steps_mean']:.1f} steps, "
        f"device {dev['device_ms_mean']:.3f} ms/chunk (rel program alone,"
        f" warm)")
    log(f"[scale] guard_flagged={st['guard_flagged']} "
        f"min_margin={st['min_margin']} oracle sample "
        f"{len(picks) - len(bad)}/{len(picks)} equal")
    if bad:
        raise PhaseError(f"reads differ from the exact oracle: {bad}")
    if st["wall_stage"] != "native":
        raise PhaseError("wall stage is not the native library")
    return res


def phase_served() -> dict:
    from classpro_tpu.serve import request

    sock = os.path.join(".smoke", "cp.sock")      # relative: short path
    srv = subprocess.Popen(
        [sys.executable, "-m", "classpro_tpu.cli", "--platform", PLATFORM,
         "serve", "--socket", sock], cwd=REPO, env=child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([srv.stdout], [], [], 300)
        if not ready or srv.stdout.readline().strip() != "READY":
            raise PhaseError(f"serve did not start: "
                             f"{srv.stderr.read()[-3000:]}")
        jobs = []
        for name in ("medium", "medium", "tiny"):
            fx = os.path.join(FIX, name)
            out = os.path.join(WORK, "out", f"served_{len(jobs)}.class")
            r = cli("classify", "--server", sock,
                    os.path.join(fx, "reads.fasta.gz"), "-N",
                    os.path.join(fx, "reads"), "-o", out,
                    what=f"classify --server {name}")
            want = os.path.join(WORK, "gold", name + ".class")
            if not os.path.exists(want):
                _gunzip(os.path.join(fx, "golden.class.gz"), want)
            jobs.append({"input": name, "job_s": r.wall_s,
                         "identical": _same(out, want)})
            log(f"[served] job {len(jobs)} {name}: identical="
                f"{jobs[-1]['identical']} client wall {r.wall_s:.2f}s")
        request(sock, {"cmd": "shutdown"}, timeout=30)
        srv.wait(timeout=60)
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
    if srv.returncode != 0:
        raise PhaseError(f"serve exited {srv.returncode}")
    if not all(j["identical"] for j in jobs):
        raise PhaseError("a served job's output differs from its golden")
    return {"jobs": jobs}


def phase_div_cr() -> dict:
    res = worker("div_check()", timeout=600)
    log(f"[div_cr] {res['pairs']} pairs: _div_cr != IEEE on "
        f"{res['div_cr_mismatch']} (unit-test cases "
        f"{res['div_cr_case_mismatch']}), x/x = {res['div_cr_x_over_x']};"
        f" plain '/' != IEEE on {res['plain_div_mismatch']}; _two_prod "
        f"inexact on {res['two_prod_inexact']} of "
        f"{res['two_prod_checked']}")
    if (res["div_cr_mismatch"] or res["div_cr_x_over_x"] != 1.0
            or res["two_prod_inexact"]):
        raise PhaseError("_div_cr is not correctly rounded on the card")
    return res


def phase_round_robin4() -> dict:
    root, meta = scale_dataset()
    outs, res = {}, {}
    for n in (1, 4):
        outs[n] = os.path.join(WORK, "out", f"scale_dev{n}.class")
        r = cli("classify", "--devices", str(n), root + ".fasta", "-o",
                outs[n], timeout=900, what=f"classify --devices {n}")
        res[f"wall_s_{n}"] = r.wall_s
        log(f"[round_robin4] --devices {n}: {r.wall_s:.2f}s = "
            f"{meta['n_kmers'] / r.wall_s / 1e6:.2f} Mk-mers/s")
    res["identical"] = _same(outs[1], outs[4])
    with open(outs[1], "rb") as f:
        res["sha256"] = hashlib.sha256(f.read()).hexdigest()
    log(f"[round_robin4] --devices 4 identical to --devices 1: "
        f"{res['identical']}; output sha256 {res['sha256']}")
    if not res["identical"]:
        raise PhaseError("--devices 4 output differs from --devices 1")
    _check_records(outs[4], root, meta)
    return res


def phase_shard_driver4() -> dict:
    root, _ = scale_dataset()
    one = os.path.join(WORK, "out", "scale_dev1.class")
    if not os.path.exists(one):
        cli("classify", root + ".fasta", "-o", one, timeout=900)
    out = os.path.join(WORK, "out", "scale_drv.class")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "classpro_tpu.parallel.driver",
         root + ".fasta", "-o", out, "--nproc", "4", "--pid", str(p),
         "--coord", f"localhost:{port}"], cwd=REPO, env=child_env(),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for p in range(4)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=900)
            if p.returncode != 0:
                errs.append(err[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errs:
        raise PhaseError(f"shard driver failed: {errs}")
    wall = time.time() - t0
    same = _same(out, one)
    log(f"[shard_driver4] 4 pinned processes + merge: {wall:.2f}s, "
        f"identical to one card: {same}")
    if not same:
        raise PhaseError("merged shard output differs from one card")
    return {"wall_s": wall, "identical": same}


def mesh_dryrun(n: int) -> None:
    """Child: __graft_entry__.dryrun_multichip over n cards."""
    jax = _gpu_jax()
    import __graft_entry__ as g

    g.dryrun_multichip(n)
    print(json.dumps({"ok": True, "devices": len(jax.devices())}))


def phase_mesh4() -> dict:
    res = worker("mesh_dryrun(4)", timeout=900)
    log("[mesh4] dryrun_multichip(4): psum + sharded classify == oracle, "
        "round-robin == single device")
    return res


PHASES = {"golden": phase_golden, "scale": phase_scale,
          "served": phase_served, "div_cr": phase_div_cr,
          "round_robin4": phase_round_robin4,
          "shard_driver4": phase_shard_driver4, "mesh4": phase_mesh4}


def _nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return r.stdout.strip() or r.stderr.strip()


def _cache_as_found() -> str:
    from classpro_tpu.backend import compile_cache_dir

    d = compile_cache_dir()
    n = len(os.listdir(d)) if os.path.isdir(d) else 0
    return f"{d} (as found: {n} entries)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phases")
    a = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "classpro_tpu")):
        print(f"chip_smoke: no classpro_tpu package next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.chdir(REPO)             # the serve socket path is relative to it
    for sub in ("out", "gold"):
        os.makedirs(os.path.join(WORK, sub), exist_ok=True)
    t_start = time.time()
    report: dict = {"phases": {}, "failed": []}
    try:
        dev = worker("probe()", timeout=600)
    except PhaseError as e:
        print(f"chip_smoke: device check failed: {e}", file=sys.stderr)
        return 1
    smi = _nvidia_smi()
    report.update(device=dev, nvidia_smi=smi,
                  compile_cache=_cache_as_found())
    log(f"[device] {smi}")
    log(f"[device] platform {dev['platform']} kind {dev['kind']} x"
        f"{dev['count']}; jax {dev['jax']}; backend "
        f"{dev['backend_version']}; plugins {dev['cuda_plugins']}; "
        f"wall stage {dev['wall_stage']}")
    log(f"[device] compile cache {report['compile_cache']}")
    if dev["platform"] != "gpu" or dev["wall_stage"] != "native":
        print("chip_smoke: no GPU, or the native host library did not "
              "load", file=sys.stderr)
        return 1
    if a.four_cards and dev["count"] < 4:
        print(f"chip_smoke: --four-cards needs 4 cards, JAX sees "
              f"{dev['count']}", file=sys.stderr)
        return 1
    for name in select_phases(a.four_cards):
        t0 = time.time()
        try:
            report["phases"][name] = PHASES[name]()
            log(f"[{name}] passed in {time.time() - t0:.1f}s")
        except Exception as e:       # reported; the run exits non-zero
            report["failed"].append(name)
            report["phases"][name] = {"error": f"{type(e).__name__}: {e}"}
            log(f"[{name}] FAILED in {time.time() - t0:.1f}s: "
                f"{type(e).__name__}: {str(e)[:3000]}")
    report["wall_s"] = time.time() - t_start
    with open(os.path.join(WORK, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] {report['wall_s']:.1f}s; failed phases: "
        f"{report['failed'] or 'none'}")
    if report["failed"]:
        return 1
    log(smi)          # the card(s) as nvidia-smi names them: name, limit
    print(result_line(dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
