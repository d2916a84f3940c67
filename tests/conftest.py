"""Test configuration: force CPU JAX with a virtual 8-device mesh and f64."""
import os
import sys

# A pytest plugin (jaxtyping) may import jax before any conftest runs,
# baking jax_platforms from the environment — so force the
# already-imported config too.
os.environ["JAX_PLATFORMS"] = "cpu"
if "jax" in sys.modules:
    sys.modules["jax"].config.update("jax_platforms", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_ENABLE_X64", "1")

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
