"""Byte identity on the GPU (marker ``gpu``).

The rest of the suite runs on the CPU backend (conftest.py).  This test
classifies the tiny fixture on the card in a fresh process, through the
CLI with ``--platform gpu``, and byte-compares it with the reference
golden.  It skips where there is no card; on the card run
``python -m pytest -m gpu tests`` (``python chip_smoke.py`` covers the
same check and more).
"""
import gzip
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

FIX = pathlib.Path(__file__).parent / "fixtures"


@pytest.mark.gpu
def test_gpu_byte_identity(tmp_path):
    if not shutil.which("nvidia-smi"):
        pytest.skip("no NVIDIA GPU on this machine")
    fix = FIX / "tiny"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)          # conftest forced the CPU
    env.pop("XLA_FLAGS", None)
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = tmp_path / "ours.class"
    subprocess.run(
        [sys.executable, "-m", "classpro_tpu.cli", "--platform", "gpu",
         "classify", str(fix / "reads.fasta.gz"), "-N", str(fix / "reads"),
         "-o", str(out)],
        env=env, check=True, capture_output=True, timeout=1800)
    golden = gzip.decompress((fix / "golden.class.gz").read_bytes())
    assert out.read_bytes() == golden
