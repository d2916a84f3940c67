"""chip_smoke.py's phase selection, result line and refusals (its
device phases run only on the card)."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("four", [False, True])
def test_phase_selection(four):
    s = _smoke()
    got = s.select_phases(four)
    assert set(got) <= set(s.PHASES)
    if four:
        assert got == ("round_robin4", "shard_driver4", "mesh4")
    else:
        assert got == ("golden", "scale", "served", "div_cr")
        assert not set(got) & set(s.FOUR_CARD_PHASES)


def test_result_line_format():
    s = _smoke()
    line = s.result_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                          "count": 1, "jax": "x"})
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_timed_compiles_use_an_emptied_fixed_cache(monkeypatch):
    """The scale phase's cold compile is timed in a fixed directory of
    the checkout, not in a cache set from outside that may be warm."""
    s = _smoke()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/warm")
    env = s.cold_cache_env()
    assert env["JAX_COMPILATION_CACHE_DIR"] == s.COLD_CACHE
    assert pathlib.Path(s.COLD_CACHE).parent == REPO / ".smoke"
    assert s.child_env()["JAX_COMPILATION_CACHE_DIR"] == "/elsewhere/warm"


def _run(script, cwd):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_without_accelerator():
    """No GPU: non-zero exit and no result line."""
    if shutil.which("nvidia-smi"):
        pytest.skip("a GPU is present")
    r = _run(REPO / "chip_smoke.py", REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "device check failed" in r.stderr


def test_fails_alone_outside_the_repo(tmp_path):
    """Copied into a directory without the package: non-zero exit and
    no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
