"""End-to-end concordance of the production engine vs the reference golden."""
import gzip
import pathlib

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

FIX = pathlib.Path(__file__).parent / "fixtures"


def _gold(fx):
    out = []
    with gzip.open(FIX / fx / "golden.class.gz", "rt") as f:
        while True:
            h = f.readline()
            if not h:
                break
            s = f.readline().rstrip("\n")
            f.readline()
            c = f.readline().rstrip("\n")
            out.append(c)
    return out


def test_engine_byte_identity_tiny_subset():
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import TpuEngine

    gold = _gold("tiny")
    gm = build_global_model(load_histogram(str(FIX / "tiny" / "reads")))
    P = open_profiles(str(FIX / "tiny" / "reads"))
    reads = list(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))[:64]
    profs = [P.fetch(i) for i in range(64)]
    eng = TpuEngine(gm, batch_size=64)
    out = eng.classify_chunk([r.seq for r in reads], profs)
    nbad = sum(1 for i in range(64) if out[i] != gold[i])
    assert nbad == 0, f"{nbad}/64 reads differ from reference golden"


@pytest.mark.slow
def test_engine_byte_identity_tiny_full():
    from classpro_tpu.tpu.engine import classify_file_tpu

    gold = _gold("tiny")
    n = bad = 0
    for rid, rec in enumerate(classify_file_tpu(
            str(FIX / "tiny" / "reads.fasta.gz"), str(FIX / "tiny" / "reads"))):
        n += 1
        bad += rec.classes != gold[rid]
    assert n == len(gold) and bad == 0


def test_native_wall_matches_oracle_sample():
    from classpro_tpu.context import seq_context
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.exact.wall import WallFinder
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import make_wall_stage, _PyWall

    gm = build_global_model(load_histogram(str(FIX / "tiny" / "reads")))
    wall = make_wall_stage(gm)
    if isinstance(wall, _PyWall):
        pytest.skip("no native library")
    wf = WallFinder(gm)
    P = open_profiles(str(FIX / "tiny" / "reads"))
    reads = list(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))[:16]
    for rid, rec in enumerate(reads):
        prof = P.fetch(rid)
        arr, nrel = wall.wall_stage(rec.seq.encode(), prof)
        lc, rcx = seq_context(rec.seq.encode())
        ivs = wf.find_wall(prof, lc, rcx)
        rel = wf.find_rel_intvl(ivs)
        assert len(arr) == len(ivs) and nrel == len(rel)
        for a, I in zip(arr, ivs):
            assert (a["b"], a["e"], a["cb"], a["ce"]) == (I.b, I.e, I.cb, I.ce)
            assert bool(a["is_rel"]) == I.is_rel
            assert a["pe"] == I.pe or (np.isinf(a["pe"]) and np.isinf(I.pe))


def test_graft_entry_single_and_multichip():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert np.asarray(out).shape == (8, 4)
    n = min(len(jax.devices()), 8)
    if n >= 2:
        g.dryrun_multichip(n)


def test_dryrun_catches_injected_routing_bug():
    """The multichip dryrun must BITE (VERDICT r3 #2): with the
    shard->device routing deliberately mangled (shard axis rotated by
    one), the per-device oracle comparison must fail.  Guards the
    dryrun against regressing into a replication check."""
    import __graft_entry__ as g
    import classpro_tpu.parallel.mesh as mesh_mod

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    orig = mesh_mod.sharded_classify

    def rotated(mesh, fblobs, iblobs, PP, dims):
        return orig(mesh, np.roll(fblobs, 1, axis=0),
                    np.roll(iblobs, 1, axis=0), PP, dims)

    mesh_mod.sharded_classify = rotated
    try:
        with pytest.raises(AssertionError, match="sharded output"):
            g.dryrun_multichip(4)
    finally:
        mesh_mod.sharded_classify = orig


def test_native_context_matches_reference_recurrences():
    """The on-demand context scans must reproduce the full-table
    recurrences exactly, including the reference's capped-backfill
    artifact for homopolymer runs longer than 127 (see csrc)."""
    import ctypes
    import random

    from classpro_tpu import native

    if not native.available():
        pytest.skip("no native library")
    lib = native.get_lib()
    lib.cp_seq_context.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int]
    rng = random.Random(123)
    cases = []
    for L in (1, 2, 5, 17, 60, 200):
        for alpha in ("AC", "ACGT", "A"):
            cases += ["".join(rng.choice(alpha) for _ in range(L))
                      for _ in range(10)]
    for u in ("A", "AC", "ACG"):
        for reps in (5, 126, 127, 128, 200):
            cases += [u * reps, "T" + u * reps + "G"]
    for s in cases:
        L = len(s)
        ref = [np.zeros(L * 3, np.uint8) for _ in range(2)]
        fast = [np.zeros(L * 3, np.uint8) for _ in range(2)]
        lib.cp_seq_context(s.encode(), L, ref[0].ctypes.data,
                           ref[1].ctypes.data, 0)
        lib.cp_seq_context(s.encode(), L, fast[0].ctypes.data,
                           fast[1].ctypes.data, 1)
        assert np.array_equal(ref[0], fast[0]), s
        assert np.array_equal(ref[1], fast[1]), s


def test_classify_stream_matches_chunks():
    """The pipelined stream yields per-chunk results identical to the
    synchronous path, in input order (engine.py classify_stream)."""
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import TpuEngine

    gm = build_global_model(load_histogram(str(FIX / "tiny" / "reads")))
    P = open_profiles(str(FIX / "tiny" / "reads"))
    reads = list(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))
    n = min(len(reads), 150)
    seqs = [r.seq for r in reads[:n]]
    profs = [P.fetch(i) for i in range(n)]

    eng = TpuEngine(gm, batch_size=64)
    B = 64
    chunks = [(seqs[i:i + B], profs[i:i + B]) for i in range(0, n, B)]
    want = [eng.classify_chunk(s, p) for s, p in chunks]
    got = list(eng.classify_stream(iter(chunks)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


def test_wall_stage_slab_overflow_retry():
    """wall_stage_slab retries the whole batch with a larger slot when a
    read's interval count exceeds the slot (native.py)."""
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.native import NativeWall

    gm = build_global_model(load_histogram(str(FIX / "tiny" / "reads")))
    P = open_profiles(str(FIX / "tiny" / "reads"))
    reads = list(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))[:8]
    seqs = [r.seq.encode("ascii") for r in reads]
    profs = [P.fetch(i) for i in range(8)]
    nw = NativeWall(gm)
    big, n_big, r_big, _ = nw.wall_stage_slab(seqs, profs)
    small, n_small, r_small, slot = nw.wall_stage_slab(seqs, profs, slot=8)
    assert slot > 8  # retried with a larger slot
    assert (n_big == n_small).all() and (r_big == r_small).all()
    for i in range(8):
        a = big.reshape(8, -1)[i][: n_big[i]]
        b = small.reshape(8, -1)[i][: n_small[i]]
        assert (a == b).all()


def test_classify_chunk_empty_and_mixed_profiles():
    """Reads with empty profiles come back as all-N, mixed with normal
    reads (engine classify_chunk / classify_stream)."""
    import numpy as np

    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import TpuEngine

    gm = build_global_model(load_histogram(str(FIX / "tiny" / "reads")))
    P = open_profiles(str(FIX / "tiny" / "reads"))
    reads = list(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))[:4]
    seqs = [r.seq for r in reads]
    profs = [P.fetch(i) for i in range(4)]
    gold = TpuEngine(gm).classify_chunk(seqs, profs)
    seqs2 = [seqs[0], seqs[1], "A" * 50, seqs[2], seqs[3]]
    profs2 = [profs[0], profs[1], np.zeros(0, np.uint16), profs[2], profs[3]]
    out = TpuEngine(gm).classify_chunk(seqs2, profs2)
    assert out[2] == "N" * 50
    assert [out[0], out[1], out[3], out[4]] == gold


def test_long_reads_match_oracle():
    """Reads near MAX_READ_LEN (const.c:57) through the production
    engine equal the scalar oracle (stress for slot sizing, bucketed
    scan lengths and the pipelined stream)."""
    import pathlib
    import tempfile

    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.exact.pipeline import ReadClassifier
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tools.simulate import SimConfig, generate_dataset
    from classpro_tpu.tpu.engine import TpuEngine

    with tempfile.TemporaryDirectory() as td:
        generate_dataset(td, SimConfig(
            seed=11, genome_len=120_000, coverage=12.0,
            read_len_mean=55_000, read_len_sd=4_000, read_len_min=40_000))
        root = str(pathlib.Path(td) / "reads")
        gm = build_global_model(load_histogram(root))
        P = open_profiles(root)
        reads = list(read_fastx(root + ".fasta"))
        n = min(len(reads), 6)
        seqs = [r.seq for r in reads[:n]]
        profs = [P.fetch(i) for i in range(n)]
        assert max(len(s) for s in seqs) >= 40_000
        got = TpuEngine(gm, batch_size=4).classify_chunk(seqs, profs)
        rc = ReadClassifier(gm)
        for i in range(n):
            assert got[i] == rc.classify(seqs[i], profs[i]), f"read {i}"


def test_alldev_fallback_matches_native():
    """The no-compiler fallback (_PyWall + classify_batch_dev, also the
    mesh path's program) classifies identically to the production
    path."""
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import TpuEngine, _PyWall

    gm = build_global_model(load_histogram(str(FIX / "tiny" / "reads")))
    P = open_profiles(str(FIX / "tiny" / "reads"))
    reads = list(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))[:6]
    seqs = [r.seq for r in reads]
    profs = [P.fetch(i) for i in range(6)]
    want = TpuEngine(gm).classify_chunk(seqs, profs)
    eng = TpuEngine(gm)
    eng.wall = _PyWall(gm)          # force the fallback
    got = eng.classify_chunk(seqs, profs)
    assert got == want


def test_shape_bucket_count_stays_low():
    """Cold-start guardrail: every distinct (R, max_m) shape is a
    separate compile, so the coarse _bucket_m ladder must keep a
    dataset to 1-2 buckets.  Regression-pins the ladder against the
    medium fixture's n_rel spread and the bucket invariants."""
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import (_bucket, _bucket_m, _M_LADDER,
                                         make_wall_stage)

    assert all(a < b for a, b in zip(_M_LADDER, _M_LADDER[1:]))
    for x in (1, 31, 32, 33, 127, 128, 129, 1024, 5000):
        assert _bucket_m(x) >= x
    assert _bucket(200) == 256 and _bucket(256) == 256

    root = str(FIX / "medium" / "reads")
    gm = build_global_model(load_histogram(root))
    P = open_profiles(root)
    reads = list(read_fastx(str(FIX / "medium" / "reads.fasta.gz")))
    wall = make_wall_stage(gm)
    nrels = []
    for rid, rec in enumerate(reads):
        _, nr = wall.wall_stage(rec.seq.encode("ascii"), P.fetch(rid))
        nrels.append(nr)
    shapes = set()
    B = 200
    for lo in range(0, len(nrels), B):
        chunk = nrels[lo: lo + B]
        shapes.add((_bucket(len(chunk)), _bucket_m(max(chunk))))
    assert len(shapes) <= 2, shapes


def test_cold_shape_absorption_matches_exact_buckets():
    """A tail chunk whose natural (R, max_m) bucket is uncompiled must
    absorb into an already-warm larger shape (engine._absorb_shape) —
    saving a compile per dataset — with byte-identical output to
    exact-bucket classification."""
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import TpuEngine

    root = str(FIX / "medium" / "reads")
    gm = build_global_model(load_histogram(root))
    P = open_profiles(root)
    reads = list(read_fastx(str(FIX / "medium" / "reads.fasta.gz")))
    seqs = [r.seq for r in reads[:260]]
    profs = [P.fetch(i) for i in range(260)]

    # stream: one full 200-read chunk (R=256) then a 60-read tail
    eng = TpuEngine(gm, batch_size=200)
    chunks = [(seqs[:200], profs[:200]), (seqs[200:260], profs[200:260])]
    got = [c for out in eng.classify_stream(iter(chunks)) for c in out]
    # the tail's natural bucket is R=64; absorption must have reused
    # the warm R=256 executable instead of compiling a second shape
    shapes = {(k[0]) for k in eng._exec_cache}
    assert shapes == {256}, eng._exec_cache.keys()

    # exact-bucket control: with the PROCESS-GLOBAL cache emptied, a
    # fresh engine's tail runs at its NATURAL bucket (absorption has
    # nothing warm to absorb into)
    import classpro_tpu.tpu.engine as E

    eng2 = TpuEngine(gm, batch_size=200)
    want = eng2.classify_chunk(seqs[:200], profs[:200])
    saved = dict(E._AOT_CACHE)
    try:
        E._AOT_CACHE.clear()
        eng3 = TpuEngine(gm, batch_size=200)
        want += eng3.classify_chunk(seqs[200:260], profs[200:260])
        assert any(k[0] < 256 for k in eng3._exec_cache), \
            "tail engine should have used its natural smaller bucket"
    finally:
        # restore EXACTLY: eng3's own (64, ...) build must not leak
        # into the cross-engine check below
        E._AOT_CACHE.clear()
        E._AOT_CACHE.update(saved)
    assert got == want

    # cross-engine absorption (the `cli serve` per-job case): a FRESH
    # engine in a warm process absorbs into shapes a previous engine
    # already built, instead of compiling its own natural bucket
    eng4 = TpuEngine(gm, batch_size=200)
    got_tail = eng4.classify_chunk(seqs[200:260], profs[200:260])
    assert {k[0] for k in eng4._exec_cache} == {256}, \
        eng4._exec_cache.keys()
    assert got_tail == want[200:260]


def test_warmup_smoke():
    """warmup pre-builds rel programs without error (tiny shapes)."""
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram
    from classpro_tpu.tpu.engine import TpuEngine

    gm = build_global_model(load_histogram(str(FIX / "tiny" / "reads")))
    eng = TpuEngine(gm)
    eng.warmup(shapes=((8, 32),))
    assert (8, 32) in eng._exec_cache


def test_cli_warmup_dataset_aware(tmp_path, capsys):
    """classify_file_tpu(warmup=True) samples the wall stage and warms
    ONE dataset-sized shape; with absorption, the stream then runs
    without additional buckets, byte-identical to the no-warmup path."""
    import gzip

    from classpro_tpu.io.classfile import write_class
    from classpro_tpu.tpu.engine import classify_file_tpu

    src = FIX / "tiny"
    fa = tmp_path / "reads.fasta"
    fa.write_bytes(gzip.decompress((src / "reads.fasta.gz").read_bytes()))
    for fn in ("reads.prof", ".reads.pidx.1", ".reads.prof.1",
               "reads.hist"):
        (tmp_path / fn).write_bytes((src / fn).read_bytes())
    out = tmp_path / "w.class"
    write_class(str(out), classify_file_tpu(
        str(fa), str(tmp_path / "reads"), warmup=True))
    golden = gzip.decompress(
        (src / "golden.class.gz").read_bytes()).decode()
    assert out.read_text() == golden
    assert "warming up device program for shape" in capsys.readouterr().err


def test_multidevice_round_robin_matches_single():
    """TpuEngine(devices=[d0, d1, ...]) round-robins whole chunks over
    local chips (replicated tables, zero cross-device traffic) and must
    yield exactly the single-device outputs — including a chunk with an
    empty profile and a trailing partial chunk."""
    import jax

    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import TpuEngine

    gm = build_global_model(load_histogram(str(FIX / "tiny" / "reads")))
    P = open_profiles(str(FIX / "tiny" / "reads"))
    reads = list(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))[:45]
    seqs = [r.seq for r in reads]
    profs = [P.fetch(i) for i in range(45)]
    profs[7] = np.zeros(0, np.uint16)
    B = 10                                   # 4 full chunks + partial

    def run(eng):
        chunks = ((seqs[i:i + B], profs[i:i + B])
                  for i in range(0, 45, B))
        return [c for out in eng.classify_stream(chunks) for c in out]

    want = run(TpuEngine(gm, batch_size=B))
    devs = jax.devices()[:3]
    assert len(devs) == 3, "conftest should provide 8 virtual devices"
    eng = TpuEngine(gm, batch_size=B, devices=devs)
    assert run(eng) == want
    # every device got at least one chunk
    assert eng._rr >= len(devs)


def test_exact_tie_guard_read94():
    """Regression for fuzz seed 8339 read 94: the forward DP hits an
    EXACT f64 tie between two *different* expressions at a predecessor
    argmax (both sum to -33.443777191362784); C's first-wins order keeps
    HAPLO, while interpolated-table values break the tie arbitrarily.
    The device's exactness guard must flag the row (margin 0 < eps) and
    the engine recompute it with the oracle, byte-matching the
    reference."""
    import gzip

    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram
    from classpro_tpu.tpu.engine import TpuEngine

    fx = FIX / "tie8339"
    gm = build_global_model(load_histogram(str(fx / "reads")))
    seq = gzip.open(fx / "read94.fa.gz", "rt").read().split("\n")[1]
    prof = np.load(fx / "prof94.npy")
    golden = gzip.open(fx / "golden94.txt.gz", "rt").read().rstrip("\n")
    eng = TpuEngine(gm)
    got = eng.classify_chunk([seq], [prof])[0]
    assert got == golden


def test_div_cr_is_correctly_rounded():
    """_div_cr must return the IEEE correctly-rounded quotient even
    where the backend's native divide is off (BASELINE_MEASURED.md:
    XLA x/x measured 1 - 128 ulp).  Reference = numpy scalar division
    (libm/IEEE, what the reference binary computes)."""
    import numpy as np

    from classpro_tpu.tpu.rel_dev2 import _div_cr

    rng = np.random.default_rng(5)
    # int-valued operands (the dh-ratio sites), x/x cases, random reals
    a = np.concatenate([
        rng.integers(1, 60000, 400).astype(np.float64),
        np.array([71.0 / 27.0, 1e3, 3.0, 7.0]),
        rng.uniform(1e-3, 1e6, 400)])
    b = np.concatenate([
        rng.integers(1, 60000, 400).astype(np.float64),
        np.array([71.0 / 27.0, 1e3, 3.0, 7.0]),   # x/x rows
        rng.uniform(1e-3, 1e6, 400)])
    import jax.numpy as jnp

    got = np.asarray(_div_cr(jnp.asarray(a), jnp.asarray(b)))
    want = a / b                                   # numpy = IEEE RN
    assert (got == want).all(), \
        f"{int((got != want).sum())} quotients differ from IEEE"
    # exact-ratio sanity: x/x must be exactly 1
    assert float(np.asarray(_div_cr(jnp.asarray(71.0 / 27.0),
                                    jnp.asarray(71.0 / 27.0)))) == 1.0


def test_relaxation_table_vs_exact_self_consistency(monkeypatch):
    """CP_EXACT_SK=1 runs the C++ relaxation with exact Bessel terms
    everywhere.  The exactness guard's contract is that the table path
    NEVER lets a table-perturbed value decide a close call — so the two
    paths must agree byte for byte."""
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import TpuEngine

    gm = build_global_model(load_histogram(str(FIX / "medium" / "reads")))
    P = open_profiles(str(FIX / "medium" / "reads"))
    reads = list(read_fastx(str(FIX / "medium" / "reads.fasta.gz")))[:150]
    seqs = [r.seq for r in reads]
    profs = [P.fetch(i) for i in range(150)]
    eng = TpuEngine(gm, batch_size=150)
    want = eng.classify_chunk(seqs, profs)
    monkeypatch.setenv("CP_EXACT_SK", "1")
    got = eng.classify_chunk(seqs, profs)
    assert got == want


def test_pack_out_roundtrip():
    """The fused device output blob (one fetch per chunk,
    device_pipeline._pack_out) must ship asgn/risky/rescue/margin
    losslessly: the risky comparison runs on-device in f64, and the
    f32 margin bytes (bitcast) must view back on the little-endian
    host."""
    import jax
    import jax.numpy as jnp

    from classpro_tpu.tpu.device_pipeline import (REL_MARGIN_EPS,
                                                  _pack_out, unpack_out)

    mm = jnp.asarray(np.array(
        [0.0, 1e-30, 3.7e-6, REL_MARGIN_EPS, 1.63e-4, np.inf, 28.7, 0.5]))
    asgn = jnp.asarray((np.arange(32, dtype=np.int8) % 4).reshape(8, 4))
    resc = jnp.asarray(np.array([1, 0, 1, 0, 0, 1, 0, 1], bool))
    buf = np.asarray(
        jax.jit(_pack_out, static_argnames="max_m")(asgn, mm, resc, 4))
    assert buf.dtype == np.uint8 and buf.shape == (8, 9)
    v, risky, r2, mm32 = unpack_out(buf, 4)
    assert (v == np.asarray(asgn)).all()
    assert (r2 == np.asarray(resc)).all()
    # 0 margin = bit-equal tie (exempt); eps itself is NOT risky (<)
    assert risky.tolist() == [False, True, True, False,
                              False, False, False, False]
    fin = np.isfinite(mm32)
    assert np.isinf(mm32[5]) and mm32[5] > 0
    assert (mm32[fin] == np.float32(np.asarray(mm))[fin]).all()


def test_aot_cache_shared_across_engines():
    """Two engines over the same dataset must share one process-global
    AOT executable per (R, max_m) bucket (engine._AOT_CACHE) — a
    per-engine cache would compile again for every dataset — and the
    second engine's output must stay byte-identical."""
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu import engine as eng_mod

    gold = _gold("tiny")
    gm = build_global_model(load_histogram(str(FIX / "tiny" / "reads")))
    P = open_profiles(str(FIX / "tiny" / "reads"))
    reads = list(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))[:32]
    profs = [P.fetch(i) for i in range(32)]
    seqs = [r.seq for r in reads]

    e1 = eng_mod.TpuEngine(gm, batch_size=32)
    out1 = e1.classify_chunk(seqs, profs)
    n_before = len(eng_mod._AOT_CACHE)
    assert n_before >= 1
    # a FRESH engine over a fresh (identical-shape) model: no new
    # executables may be compiled, and outputs must not change
    gm2 = build_global_model(load_histogram(str(FIX / "tiny" / "reads")))
    e2 = eng_mod.TpuEngine(gm2, batch_size=32)
    out2 = e2.classify_chunk(seqs, profs)
    assert len(eng_mod._AOT_CACHE) == n_before, \
        "second engine fragmented the global executable cache"
    assert out1 == out2 == [gold[i] for i in range(32)]


def test_stream_knobs_preserve_order(monkeypatch):
    """CP_STREAM_DEPTH / CP_PREFETCH are measurement knobs; any value
    must keep classify_stream's per-chunk outputs identical and in
    input order (engine.py classify_stream)."""
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import TpuEngine

    gm = build_global_model(load_histogram(str(FIX / "tiny" / "reads")))
    P = open_profiles(str(FIX / "tiny" / "reads"))
    reads = list(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))
    n = min(len(reads), 120)
    seqs = [r.seq for r in reads[:n]]
    profs = [P.fetch(i) for i in range(n)]
    eng = TpuEngine(gm, batch_size=40)
    chunks = [(seqs[i:i + 40], profs[i:i + 40]) for i in range(0, n, 40)]
    want = [eng.classify_chunk(s, p) for s, p in chunks]
    for depth, pref in (("1", "0"), ("5", "4")):
        monkeypatch.setenv("CP_STREAM_DEPTH", depth)
        monkeypatch.setenv("CP_PREFETCH", pref)
        got = list(eng.classify_stream(iter(chunks)))
        assert got == want, (depth, pref)


def test_init_underflow_kill_seed21517():
    """Regression for fuzz seed 21517 read 82 (-M model path): the
    reference normalizes the INIT DP cell (class_rel.c init psum
    block) and a state whose softmax probability underflows to 0.0 is
    DEAD.  The device's raw-score carry must replicate that discrete
    kill (rel_dev2._lane_init): an ERROR state left alive at -753 raw
    flipped the backward pass's only_r decision — a large-margin flip
    the margin guard cannot see — turning an H run into D."""
    import gzip

    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram
    from classpro_tpu.tpu.engine import TpuEngine

    fx = FIX / "initkill21517"
    gm = build_global_model(load_histogram(str(fx / "reads")),
                            model_path=str(fx / "rand.model"))
    seq = gzip.open(fx / "read82.fa.gz", "rt").read().split("\n")[1]
    prof = np.load(fx / "prof82.npy")
    golden = gzip.open(fx / "golden82.txt.gz", "rt").read().rstrip("\n")
    eng = TpuEngine(gm)
    got = eng.classify_chunk([seq], [prof])[0]
    assert got == golden


def test_sorted_stream_matches_plain():
    """sort_window re-composes device batches from plen-ordered windows
    but must yield BYTE-identical results in the original chunk
    structure (per-read independence).  Window sizes that divide, and
    don't divide, the chunk count; uneven chunk sizes; a window
    boundary mid-dataset; empty-profile reads."""
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import TpuEngine

    gm = build_global_model(load_histogram(str(FIX / "tiny" / "reads")))
    P = open_profiles(str(FIX / "tiny" / "reads"))
    reads = list(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))
    n = len(reads)
    seqs = [r.seq for r in reads]
    profs = [P.fetch(i) for i in range(n)]
    profs[7] = profs[7][:0]          # empty-profile read inside window 0

    eng = TpuEngine(gm, batch_size=32)
    # uneven chunk sizes (the driver/CLI produce a short tail chunk)
    cuts = list(range(0, n, 32))
    chunks = [(seqs[a:b], profs[a:b])
              for a, b in zip(cuts, cuts[1:] + [n])]
    want = list(eng.classify_stream(iter(chunks)))
    for W in (2, 3, 16):
        got = list(eng.classify_stream(iter(chunks), sort_window=W))
        assert [len(c) for c in got] == [len(c) for c in want]
        assert got == want, f"sort_window={W} diverged"
