"""Warm-engine service (serve.py + `cli serve`/`classify --server`):
daemon round trip, byte-identity with the direct CLI, executable-cache
reuse across jobs, job-error isolation, shutdown.

The daemon is the cold-start amortization answer to the reference's
~1 s process start (ClassPro.c:503): device executables build once per
service lifetime instead of once per run (VERDICT r4 item 2)."""
import os
import pathlib
import subprocess
import sys
import time

import pytest

FIX = pathlib.Path(__file__).parent / "fixtures"


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _start(tmp_path, extra=()):
    sock = str(tmp_path / "cp.sock")
    p = subprocess.Popen(
        [sys.executable, "-m", "classpro_tpu.cli", "--platform", "cpu",
         "serve", "--socket", sock, *extra],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    from classpro_tpu.serve import request

    deadline = time.time() + 180
    while time.time() < deadline:
        if p.poll() is not None:
            raise AssertionError(f"daemon died: {p.stderr.read()[-2000:]}")
        if os.path.exists(sock):
            try:
                rep = request(sock, {"cmd": "ping"}, timeout=5)
                assert rep["ok"] and rep["pid"] == p.pid
                return p, sock
            except (ConnectionError, OSError):
                pass
        time.sleep(0.3)
    p.kill()
    raise AssertionError("daemon never became ready")


def test_serve_classify_round_trip_and_reuse(tmp_path):
    from classpro_tpu.cli import main as cli_main
    from classpro_tpu.serve import request

    src = str(FIX / "tiny" / "reads.fasta.gz")
    fk = str(FIX / "tiny" / "reads")
    p, sock = _start(tmp_path)
    try:
        # job 1 (cold daemon)
        out1 = str(tmp_path / "o1.class")
        rep = request(sock, {"cmd": "classify", "source": src,
                             "fastk_root": fk, "output": out1})
        assert rep["ok"], rep
        assert rep["reads"] == 221
        assert rep["warm_shapes"], "no executables cached after a job"

        # byte-identical to the direct in-process CLI
        out_direct = str(tmp_path / "direct.class")
        assert cli_main(["classify", src, "-N", fk,
                         "-o", out_direct]) == 0
        assert open(out1).read() == open(out_direct).read()

        # job 2 through `cli classify --server` reuses the warm cache
        out2 = str(tmp_path / "o2.class")
        rc = subprocess.run(
            [sys.executable, "-m", "classpro_tpu.cli", "classify",
             "--server", sock, src, "-N", fk, "-o", out2],
            env=_env(), capture_output=True, text=True, timeout=300)
        assert rc.returncode == 0, rc.stderr[-2000:]
        assert open(out2).read() == open(out_direct).read()
        rep = request(sock, {"cmd": "stats"})
        assert rep["jobs"] == 2

        # a failing job must not kill the daemon
        rep = request(sock, {"cmd": "classify",
                             "source": "/nonexistent/r.fasta"})
        assert not rep["ok"] and "error" in rep
        assert request(sock, {"cmd": "ping"})["ok"]
    finally:
        try:
            assert request(sock, {"cmd": "shutdown"})["ok"]
            p.wait(timeout=30)
        except Exception:
            p.kill()
            raise
    assert p.returncode == 0
    assert not os.path.exists(sock)


def test_serve_refuses_unsupported_client_options(tmp_path, capsys):
    from classpro_tpu.cli import main as cli_main

    src = str(FIX / "tiny" / "reads.fasta.gz")
    rc = cli_main(["classify", "--server", str(tmp_path / "no.sock"),
                   "-s", src])
    assert rc == 1
    assert "--server supports plain FASTX" in capsys.readouterr().err
