"""Auxiliary subsystems: PMM coverage VI, shard merging, timing."""
import pathlib
import struct

import numpy as np

FIX = pathlib.Path(__file__).parent / "fixtures"


def test_pmm_recovers_mixture_coverages():
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram
    from classpro_tpu.pmm import PmmModel

    hist = load_histogram(str(FIX / "medium" / "reads"))
    gm = build_global_model(hist)
    by_count = np.zeros(hist.high + 1, np.int64)
    by_count[hist.low: hist.high + 1] = hist.instance_counts()
    # corrected=True: the real harmonic-series digamma (the estimator
    # hist.c intended); the parity default (zero digamma, as compiled)
    # is goldened against the reference in test_pmm_reference_golden
    pm = PmmModel(gm, by_count, corrected=True)
    rng = np.random.default_rng(0)
    H, D = int(gm.cov[2]), int(gm.cov[3])
    prof = np.concatenate([rng.poisson(H - 2, 4000),
                           rng.poisson(D + 3, 6000)]).astype(np.uint16)
    n, lam = pm.pmm_vi(prof)
    assert n > 9000
    assert abs(lam[0] - (H - 2)) < 2.0
    assert abs(lam[1] - (D + 3)) < 2.0
    # degenerate read: too few normal counts -> priors returned
    n, lam = pm.pmm_vi(np.zeros(5, np.uint16))
    assert n < 2 and lam == [float(H), float(D)]


def test_pmm_reference_golden():
    """Bitwise parity with the -DDO_PMM reference build (pmm_harness,
    tools/build_reference.py): per-read (N, lambda_H, lambda_D) on the
    medium fixture, 398/398 bit-equal.  The golden was produced by the
    as-compiled reference — zero digamma table (ClassPro.c:540 never
    calls precompute_digamma), hist.c:159-310."""
    import gzip

    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.pmm import PmmModel

    hist = load_histogram(str(FIX / "medium" / "reads"))
    gm = build_global_model(hist)
    by_count = np.zeros(hist.high + 1, np.int64)
    by_count[hist.low: hist.high + 1] = hist.instance_counts()
    pm = PmmModel(gm, by_count)
    assert pm.alpha_prior == [1, 5]   # instance-count totpk (hist.c:116)
    golden = gzip.decompress(
        (FIX / "medium" / "golden.pmm.gz").read_bytes()).decode()
    P = open_profiles(str(FIX / "medium" / "reads"))
    lines = golden.strip().split("\n")
    assert len(lines) == P.nreads
    for i, line in enumerate(lines):
        rn, r0, r1 = line.split()
        n, lam = pm.pmm_vi(P.fetch(i))
        assert n == int(rn)
        assert lam[0] == float(r0) and lam[1] == float(r1), (
            i, lam, (r0, r1))


def test_merge_files_and_anno(tmp_path):
    from classpro_tpu.io.merge import merge_anno, merge_files

    parts = []
    for t, payload in enumerate([b"abc", b"", b"defg"]):
        p = tmp_path / f"x.class.{t}"
        p.write_bytes(payload)
        parts.append(str(p))
    dest = str(tmp_path / "x.class")
    merge_files(dest, parts)
    assert open(dest, "rb").read() == b"abcdefg"
    assert not any(pathlib.Path(p).exists() for p in parts)

    # two anno shards: offsets rebased by running data size (io.c:41-56)
    a0 = tmp_path / "a0"
    a0.write_bytes(struct.pack("<iiq", 2, 8, 0) + struct.pack("<2q", 10, 30))
    a1 = tmp_path / "a1"
    a1.write_bytes(struct.pack("<iiq", 1, 8, 0) + struct.pack("<q", 5))
    dest = str(tmp_path / "anno")
    merge_anno(dest, [str(a0), str(a1)])
    raw = open(dest, "rb").read()
    n, s, idx0 = struct.unpack_from("<iiq", raw)
    assert (n, s, idx0) == (3, 8, 0)
    assert struct.unpack_from("<3q", raw, 16) == (10, 30, 35)


def test_phase_timer_reports():
    from classpro_tpu.timing import PhaseTimer

    t = PhaseTimer()
    sum(range(10000))
    r = t.report()
    assert "user" in r and "wall" in r and "max rss" in r
    assert "Total" in t.report(total=True)
