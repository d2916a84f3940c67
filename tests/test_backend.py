"""Platform selection, the no-GPU refusal of every device entry point,
the compile-cache location, and the device fields of the run stats."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"


def _env(**kw):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(kw)
    return env


@pytest.mark.parametrize("flag,want", [("gpu", "cuda"), ("cpu", "cpu")])
def test_platform_flag_sets_jax_platforms_before_jax_loads(tmp_path, flag,
                                                           want):
    """--platform picks JAX's backend through JAX_PLATFORMS, set before
    JAX is imported (a client job never imports it at all)."""
    code = (
        "import os, sys\n"
        "from classpro_tpu.cli import main\n"
        f"rc = main(['--platform', {flag!r}, 'classify', '--server',\n"
        f"           {str(tmp_path / 'no.sock')!r},\n"
        f"           {str(FIX / 'tiny' / 'reads.fasta.gz')!r}])\n"
        "print(rc, os.environ['JAX_PLATFORMS'], 'jax' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.stdout.split() == ["1", want, "False"], r.stderr


_NO_GPU_RUNS = {
    "classify --platform gpu": ["-m", "classpro_tpu.cli", "--platform",
                                "gpu", "classify"],
    "classify": ["-m", "classpro_tpu.cli", "classify"],
    "serve": ["-m", "classpro_tpu.cli", "serve", "--socket", "{sock}"],
    "shard driver": ["-m", "classpro_tpu.parallel.driver"],
    "bench": [str(REPO / "bench.py")],
}


@pytest.mark.parametrize("entry", sorted(_NO_GPU_RUNS))
def test_entry_point_without_gpu_stops(tmp_path, entry):
    """Without a GPU, and with the CPU not chosen, every device entry
    point exits non-zero with a clear message and writes no output."""
    if shutil.which("nvidia-smi"):
        pytest.skip("a GPU is present")
    out = tmp_path / "out.class"
    argv = [a.format(sock=tmp_path / "s.sock") for a in _NO_GPU_RUNS[entry]]
    if entry != "bench" and entry != "serve":
        argv += [str(FIX / "tiny" / "reads.fasta.gz"), "-N",
                 str(FIX / "tiny" / "reads"), "-o", str(out)]
    r = subprocess.run([sys.executable, *argv], env=_env(), cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "GPU" in r.stderr + r.stdout
    assert not out.exists()
    if entry == "bench":
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        assert rec["value"] is None and "NoGpuError" in rec["error"]


@pytest.mark.parametrize("outside", [True, False])
def test_compile_cache_dir(monkeypatch, outside):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed
    directory inside the checkout (never a temporary or per-run name)."""
    import jax

    from classpro_tpu import backend

    if outside:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
        assert backend.compile_cache_dir() == "/some/cache"
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert backend.compile_cache_dir() == str(REPO / ".jax_cache")
        backend.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == str(
            REPO / ".jax_cache")


def test_stats_json_reports_platform_and_wall_stage(tmp_path):
    """--stats-json names the device that ran and the wall stage, and
    carries the cold-start and DP-step telemetry."""
    from classpro_tpu.cli import main

    sj = tmp_path / "s.json"
    assert main(["classify", str(FIX / "tiny" / "reads.fasta.gz"), "-N",
                 str(FIX / "tiny" / "reads"), "-o",
                 str(tmp_path / "o.class"), "--stats-json", str(sj)]) == 0
    st = json.loads(sj.read_text())
    assert st["platform"] == "cpu" and st["device_count"] >= 1
    assert st["device_kind"]
    assert st["wall_stage"] == "native"
    assert st["reads"] == 221 and st["chunks"] == 2
    assert st["first_chunk_s"] > 0 and st["compile_s"] >= 0
    assert st["dp_steps"] > 0
