"""Test harness: CPU with 8 virtual devices and 64-bit enabled by default.

The virtual-device mesh is the single-host analogue of multi-node testing
without a cluster (SURVEY.md section 4): sharding/halo tests exercise the
same jit/GSPMD code paths that run across real cards.

Card tier: tests marked ``@pytest.mark.gpu`` need an NVIDIA GPU (the CUDA
smoother's parity, TF32-free products).  Here they skip; on a machine with
a card ``MG_TEST_PLATFORM=gpu python -m pytest tests -m gpu`` runs them, and
``python chip_smoke.py`` runs them in-process.  Whether a card is there is
decided inside the ``_gpu_only`` fixture, never at import or collection.
"""

import os

# Force CPU unless the card tier asked for the default platform.  jax may
# already be imported by a pytest plugin, so set the platform through
# jax.config as well as the env — both work before backend initialisation.
_platform = os.environ.get("MG_TEST_PLATFORM", "cpu")
if _platform == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax
import pytest

if _platform == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU (MG_TEST_PLATFORM=gpu pytest -m "
                    "gpu, or python chip_smoke.py)")
