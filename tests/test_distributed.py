"""Multi-host driver: shard partition, scatter-gather merge, and the
psum estimation path (parallel/driver.py; ref ClassPro.c:574-614,
io.c:70-176)."""
import pathlib

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

FIX = pathlib.Path(__file__).parent / "fixtures"


def test_shard_range_partition():
    from classpro_tpu.parallel.driver import shard_range

    for nreads in (1, 7, 100, 398):
        for nproc in (1, 2, 3, 8):
            spans = [shard_range(nreads, nproc, p) for p in range(nproc)]
            assert spans[0][0] == 0 and spans[-1][1] == nreads
            for (a, b), (c, d) in zip(spans, spans[1:]):
                assert b == c and a <= b and c <= d


def test_simulated_two_process_run_matches_single(tmp_path):
    """Run the per-process body twice (pid 0/1) + merge == one run."""
    from classpro_tpu.parallel.driver import merge_shards, run_process

    src = str(FIX / "tiny" / "reads.fasta.gz")
    fk = str(FIX / "tiny" / "reads")
    single = str(tmp_path / "single.class")
    run_process(src, fk, single, nproc=1, pid=0)

    multi = str(tmp_path / "multi.class")
    for pid in range(2):
        run_process(src, fk, multi, nproc=2, pid=pid, _skip_init=True)
    merge_shards(multi, 2)
    assert open(single).read() == open(multi).read()


def test_psum_estimation_matches_hist_model():
    """Instance histogram summed over shards via psum reproduces the
    .hist-file model exactly (same H/D coverages, same thresholds)."""
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.parallel.driver import (estimate_distributed,
                                              shard_range)
    from classpro_tpu.parallel.mesh import data_parallel_mesh

    root = str(FIX / "medium" / "reads")
    hist = load_histogram(root)
    gm_ref = build_global_model(hist)
    P = open_profiles(root)
    profs = [P.fetch(i) for i in range(P.nreads)]

    mesh = data_parallel_mesh(jax.devices()[:1])
    gm = estimate_distributed(mesh, profs, kmer=hist.kmer,
                              low=hist.low, high=hist.high)
    # coverage estimates must match the .hist-derived model: every k-mer
    # instance of the dataset appears at exactly one profile position
    assert (gm.cov == gm_ref.cov).all()
    assert gm.dr_ratio == gm_ref.dr_ratio


def _stage_tiny(tmp_path):
    import gzip

    fix = FIX / "tiny"
    src = tmp_path / "reads.fasta"
    src.write_bytes(gzip.decompress((fix / "reads.fasta.gz").read_bytes()))
    for fn in ("reads.prof", ".reads.pidx.1", ".reads.prof.1", "reads.hist"):
        (tmp_path / fn).write_bytes((fix / fn).read_bytes())
    return src


def _driver_env():
    import os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "1"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import os as _os
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + _os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("nproc", [2, 4])
def test_real_multi_process_jax_distributed(tmp_path, nproc):
    """SURVEY §4's prescription, for real: nproc OS processes initialize
    jax.distributed against a localhost coordinator, run
    parallel/driver.py main() end-to-end (estimation, shard classify,
    psum barrier, pid-0 merge with completeness validation), and the
    merged file equals a single-process run.  Exercises driver.py's
    jax.distributed.initialize path and psum_histogram's
    addressable-shards-only construction under real multi-process;
    nproc=4 backs the driver's claimed N-host generality beyond the
    historical 2-process ceiling."""
    import socket
    import subprocess
    import sys

    src = _stage_tiny(tmp_path)
    env = _driver_env()

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    single = tmp_path / "single.class"
    subprocess.run(
        [sys.executable, "-m", "classpro_tpu.parallel.driver", str(src),
         "-N", str(tmp_path / "reads"), "-o", str(single)],
        env=env, check=True, capture_output=True, timeout=600)

    multi = tmp_path / "multi.class"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "classpro_tpu.parallel.driver", str(src),
             "-N", str(tmp_path / "reads"), "-o", str(multi),
             "--nproc", str(nproc), "--pid", str(pid),
             "--coord", f"127.0.0.1:{port}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(nproc)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    assert multi.read_bytes() == single.read_bytes()


@pytest.mark.parametrize("visible,pid,card", [
    ("0,1,2,3", 5, 1),      # second 4-card host: its second card
    ("0,1,2,3", 3, 3),      # one 4-card host: the pid itself
    ("2", 6, 0),            # the launcher showed it one card
])
def test_driver_pins_each_process_to_a_card_of_its_host(monkeypatch, visible,
                                                        pid, card):
    """A pid beyond its host's card count asks jax.distributed for a card
    the host has: pid modulo the host's cards."""
    from classpro_tpu.parallel import driver

    seen = {}

    class _Stop(Exception):
        pass

    def fake_initialize(**kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.setattr(jax.distributed, "initialize", fake_initialize)
    with pytest.raises(_Stop):
        driver.main(["reads.fasta", "--nproc", "8", "--pid", str(pid),
                     "--coord", "localhost:8476"])
    assert seen == {"coordinator_address": "localhost:8476",
                    "num_processes": 8, "process_id": pid,
                    "local_device_ids": [card]}


def test_local_card_counts_device_nodes_without_visible_devices(
        monkeypatch):
    import os

    from classpro_tpu.parallel.driver import local_card

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    nodes = ["nvidia0", "nvidia1", "nvidiactl", "nvidia-uvm", "null"]
    monkeypatch.setattr(os, "listdir", lambda d: nodes)
    monkeypatch.setattr(os.path, "isdir", lambda d: True)
    assert [local_card(p) for p in range(4)] == [0, 1, 0, 1]
    monkeypatch.setattr(os, "listdir", lambda d: ["null"])
    assert local_card(5) == 5


def test_shard_resume_kill_and_rerun(tmp_path):
    """Shard resume (SURVEY §5 checkpoint granularity): after a 'crash'
    that leaves shard 0 complete and shard 1 truncated mid-record, a
    --resume rerun skips shard 0 (file untouched), recomputes shard 1,
    and the validated merge equals a clean single run."""
    import os

    from classpro_tpu.parallel.driver import (merge_shards, run_process,
                                              shard_range, shard_records)
    from classpro_tpu.io.fastk import open_profiles

    src = str(_stage_tiny(tmp_path))
    fk = str(tmp_path / "reads")
    single = str(tmp_path / "single.class")
    run_process(src, fk, single, nproc=1, pid=0)

    multi = str(tmp_path / "multi.class")
    # the "first run": shard 0 completes, shard 1 dies mid-write
    run_process(src, fk, multi, nproc=2, pid=0, _skip_init=True)
    run_process(src, fk, multi, nproc=2, pid=1, _skip_init=True)
    with open(multi + ".1", "r+b") as f:
        f.truncate(os.path.getsize(multi + ".1") - 37)

    nreads = open_profiles(fk).nreads
    expected = [e - b for b, e in (shard_range(nreads, 2, p)
                                   for p in range(2))]
    assert shard_records(multi + ".0") == expected[0]
    assert shard_records(multi + ".1") != expected[1]
    # merge of the incomplete state must refuse
    with pytest.raises(RuntimeError, match="incomplete"):
        merge_shards(multi, 2, expected)

    stat0 = os.stat(multi + ".0")
    for pid in range(2):
        run_process(src, fk, multi, nproc=2, pid=pid, resume=True,
                    _skip_init=True)
    # shard 0 was skipped (not rewritten), shard 1 recomputed
    s0 = os.stat(multi + ".0")
    assert (s0.st_mtime_ns, s0.st_ino) == (stat0.st_mtime_ns, stat0.st_ino)
    assert shard_records(multi + ".1") == expected[1]
    merge_shards(multi, 2, expected)
    assert open(multi).read() == open(single).read()


def test_resume_rejects_stale_params_shard(tmp_path):
    """A structurally-complete shard produced under DIFFERENT parameters
    must not be reused: --resume verifies the params stamp, so a rerun
    with -c overridden reclassifies, and a rerun with the SAME params
    then skips (ADVICE r4)."""
    import os

    from classpro_tpu.parallel.driver import run_process

    src = str(_stage_tiny(tmp_path))
    fk = str(tmp_path / "reads")
    multi = str(tmp_path / "multi.class")
    run_process(src, fk, multi, nproc=2, pid=0, _skip_init=True)

    stat0 = os.stat(multi + ".0")
    run_process(src, fk, multi, nproc=2, pid=0, resume=True, coverage=40,
                _skip_init=True)
    s1 = os.stat(multi + ".0")
    assert s1.st_mtime_ns != stat0.st_mtime_ns       # recomputed
    run_process(src, fk, multi, nproc=2, pid=0, resume=True, coverage=40,
                _skip_init=True)
    s2 = os.stat(multi + ".0")
    assert (s2.st_mtime_ns, s2.st_ino) == (s1.st_mtime_ns, s1.st_ino)


def _stage_subset(tmp_path, n):
    """First n reads of the tiny fixture as a standalone dataset (same
    .hist, so single and sharded runs share one global model)."""
    import itertools

    from classpro_tpu.io.fastk import open_profiles, write_profiles
    from classpro_tpu.io.fastx import read_fastx, write_fasta

    fix = FIX / "tiny"
    recs = list(itertools.islice(read_fastx(str(fix / "reads.fasta.gz")),
                                 n))
    write_fasta(str(tmp_path / "reads.fasta"),
                [(r.name, r.comment, r.seq) for r in recs])
    P = open_profiles(str(fix / "reads"))
    write_profiles(str(tmp_path / "reads"), [P.fetch(i) for i in range(n)],
                   P.kmer, nparts=1)
    (tmp_path / "reads.hist").write_bytes((fix / "reads.hist").read_bytes())
    return str(tmp_path / "reads.fasta")


def test_eight_shards_uneven_with_empty_tail(tmp_path):
    """nproc=8 over 42 reads (io.c:175-176 ceil partition): per-shard
    size 6, so shards 0-6 carry all 42 reads and shard 7 is EMPTY.
    Every process still writes its (empty) shard file, the validated
    merge accepts the 0-record tail, and the result equals a single
    run (VERDICT r4 item 8: uneven + empty-tail realism)."""
    from classpro_tpu.io.fastk import open_profiles
    from classpro_tpu.parallel.driver import (merge_shards, run_process,
                                              shard_range, shard_records)

    src = _stage_subset(tmp_path, 42)
    fk = str(tmp_path / "reads")
    single = str(tmp_path / "single.class")
    run_process(src, fk, single, nproc=1, pid=0)

    nproc = 8
    nreads = open_profiles(fk).nreads
    assert nreads == 42
    spans = [shard_range(nreads, nproc, p) for p in range(nproc)]
    expected = [e - b for b, e in spans]
    assert expected[-1] == 0 and sum(expected) == nreads

    multi = str(tmp_path / "multi.class")
    for pid in range(nproc):
        run_process(src, fk, multi, nproc=nproc, pid=pid, _skip_init=True)
    assert shard_records(multi + f".{nproc - 1}") == 0
    merge_shards(multi, nproc, expected)
    assert open(multi).read() == open(single).read()


def test_four_shard_resume_after_kill(tmp_path):
    """Resume at 4 shards (VERDICT r4 item 8): shard 1 truncated
    mid-record and shard 2 deleted; --resume recomputes exactly those
    two, skips 0 and 3, and the merge equals a clean run."""
    import os

    from classpro_tpu.io.fastk import open_profiles
    from classpro_tpu.parallel.driver import (merge_shards, run_process,
                                              shard_range, shard_records)

    src = str(_stage_tiny(tmp_path))
    fk = str(tmp_path / "reads")
    single = str(tmp_path / "single.class")
    run_process(src, fk, single, nproc=1, pid=0)

    multi = str(tmp_path / "multi.class")
    for pid in range(4):
        run_process(src, fk, multi, nproc=4, pid=pid, _skip_init=True)
    with open(multi + ".1", "r+b") as f:
        f.truncate(os.path.getsize(multi + ".1") - 11)
    os.remove(multi + ".2")

    nreads = open_profiles(fk).nreads
    expected = [e - b for b, e in (shard_range(nreads, 4, p)
                                   for p in range(4))]
    stats = {p: os.stat(f"{multi}.{p}") for p in (0, 3)}
    for pid in range(4):
        run_process(src, fk, multi, nproc=4, pid=pid, resume=True,
                    _skip_init=True)
    for p in (0, 3):   # untouched
        s = os.stat(f"{multi}.{p}")
        assert (s.st_mtime_ns, s.st_ino) == (stats[p].st_mtime_ns,
                                             stats[p].st_ino)
    for p in (1, 2):   # recomputed
        assert shard_records(f"{multi}.{p}") == expected[p]
    merge_shards(multi, 4, expected)
    assert open(multi).read() == open(single).read()
