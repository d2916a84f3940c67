"""Device platform selection and the persistent compile cache.

The classify path runs its device programs on a GPU.  The CPU backend
runs the same programs and gives the same bytes; it is used only when
chosen explicitly (``--platform cpu`` or ``JAX_PLATFORMS=cpu``, which
is how the tests run).  A run that did not choose the CPU and finds no
GPU stops with an error instead of carrying on on the CPU.
"""

from __future__ import annotations

import os
import sys

# --platform value -> JAX_PLATFORMS value
_JAX_PLATFORM = {"gpu": "cuda", "cpu": "cpu"}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class NoGpuError(RuntimeError):
    """A GPU was asked for (or the CPU was not chosen) and none exists."""


def select_platform(name: str | None) -> None:
    """Point JAX at ``name`` ('gpu' or 'cpu', None = leave as is).
    Must run before JAX initialises a backend."""
    if name is None:
        return
    value = _JAX_PLATFORM[name]
    os.environ["JAX_PLATFORMS"] = value
    jax = sys.modules.get("jax")
    if jax is not None:     # imported but no backend yet: the env is read
        jax.config.update("jax_platforms", value)    # only at import


def require_gpu() -> None:
    """Raise NoGpuError unless JAX's default device is a GPU or the CPU
    was chosen explicitly."""
    import jax

    if jax.config.jax_platforms == "cpu":
        return
    try:
        platform = jax.devices()[0].platform
    except Exception as e:      # JAX_PLATFORMS=cuda without a card or plugin
        raise NoGpuError(f"no GPU backend could be initialised ({e}); "
                         f"use --platform cpu to run on the CPU") from None
    if platform != "gpu":
        raise NoGpuError(f"JAX found no GPU (its default backend is "
                         f"{platform!r}); use --platform cpu to run on "
                         f"the CPU")


def device_info() -> dict:
    """Platform, device kind and count of JAX's default backend."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else one fixed directory in
    the checkout (the path is part of the cache key, so it must not
    move between runs)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO, ".jax_cache"))


def enable_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache (before the first
    compile).  JAX reads JAX_COMPILATION_CACHE_DIR itself; only the
    in-checkout default is set here."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
